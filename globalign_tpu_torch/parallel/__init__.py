"""Multi-process helpers of the port (``multihost``: chunk dealing and
per-process output shards).  Sharding across devices is not ported yet."""

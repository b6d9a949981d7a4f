from .gotoh import GotohAligner, GotohAlignment

__all__ = ["GotohAligner", "GotohAlignment"]

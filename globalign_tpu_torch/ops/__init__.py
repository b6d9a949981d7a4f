from . import fill_cuda, fill_rows, fill_scan, traceback, transforms

__all__ = ["fill_cuda", "fill_rows", "fill_scan", "traceback", "transforms"]

from iterative_cleaner_tpu_torch.backends.base import CleanerBackend, make_backend

__all__ = ["CleanerBackend", "make_backend"]

from iterative_cleaner_tpu_torch.io.base import Archive, ArchiveIO, get_io

__all__ = ["Archive", "ArchiveIO", "get_io"]

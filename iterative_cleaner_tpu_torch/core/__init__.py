from iterative_cleaner_tpu_torch.core.cleaner import CleanResult, clean_cube, find_bad_parts

__all__ = ["CleanResult", "clean_cube", "find_bad_parts"]

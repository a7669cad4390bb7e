from iterative_cleaner_tpu_torch.models.surgical import SurgicalCleaner, SurgicalOutput

__all__ = ["SurgicalCleaner", "SurgicalOutput"]

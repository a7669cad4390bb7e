"""Process utilities: the CUDA initialisation probe and its watchdog."""

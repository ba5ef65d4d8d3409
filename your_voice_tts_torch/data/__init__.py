from .dataset import TTSDataset
from .formatters import load_meta_data

__all__ = ["TTSDataset", "load_meta_data"]

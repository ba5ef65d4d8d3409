from .factory import setup_model

__all__ = ["setup_model"]

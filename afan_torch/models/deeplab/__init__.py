from .modeling import MODEL_MAP, DeepLab, build_model

__all__ = ["DeepLab", "MODEL_MAP", "build_model"]

from .pipeline import Classifier, ClassifyOptions

__all__ = ["Classifier", "ClassifyOptions"]

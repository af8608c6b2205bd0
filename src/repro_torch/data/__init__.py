from .pipeline import SyntheticLMData, make_train_iterator

__all__ = ["SyntheticLMData", "make_train_iterator"]

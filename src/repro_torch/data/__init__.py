from .pipeline import SyntheticLMData, SyntheticStubData, \
    make_train_iterator, train_data

__all__ = ["SyntheticLMData", "SyntheticStubData", "make_train_iterator",
           "train_data"]

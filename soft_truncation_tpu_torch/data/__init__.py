"""Data of the PyTorch port: scalers, sources and batches."""

from .datasets import (BatchIterator, eval_batches, eval_split,
                       get_data_inverse_scaler, get_data_scaler,
                       get_eval_iterator, get_train_iterator,
                       make_preprocess_fn, pipeline, transport_uint8)
from .native import NativeBatcher

__all__ = ["BatchIterator", "NativeBatcher", "eval_batches", "eval_split",
           "get_data_inverse_scaler", "get_data_scaler", "get_eval_iterator",
           "get_train_iterator", "make_preprocess_fn", "pipeline",
           "transport_uint8"]

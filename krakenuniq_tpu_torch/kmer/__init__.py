from .encode import encode_batch, EncodedBatch, BASE_CODE_TABLE
from . import ops

__all__ = ["encode_batch", "EncodedBatch", "BASE_CODE_TABLE", "ops"]

"""Codebook query ops: plain PyTorch versions and the CUDA kernel wrappers."""

from .multi_codebook import (
    grouped_codebook_top1,
    grouped_codebook_topk,
    multi_codebook_top1,
    stack_codebooks,
)
from .nn_query import (
    cosine_similarities,
    cosine_similarity_topk,
    cosine_top1,
    cosine_top1_cuda,
    cosine_topk,
    l2_normalize,
)

__all__ = [
    "cosine_similarities",
    "cosine_similarity_topk",
    "cosine_top1",
    "cosine_top1_cuda",
    "cosine_topk",
    "grouped_codebook_top1",
    "grouped_codebook_topk",
    "l2_normalize",
    "multi_codebook_top1",
    "stack_codebooks",
]

"""Autoregressive generation: KV-cached greedy and beam search."""

from unimp_tpu_torch.decode.sampler import GenerationConfig, Generator

__all__ = ["GenerationConfig", "Generator"]

"""Serving: controller (worker registry and dispatch), model workers
(streamed generation over the wave-batched engine), chat clients and
conversation templates. Counterpart of ``unimp_tpu/serve/``."""

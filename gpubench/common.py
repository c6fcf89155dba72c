"""What every traffic family shares: the run's context, the program's
configuration and seeded build, set-up timing and memory."""

from __future__ import annotations

import dataclasses
import gc
import os
import time

import torch

from gpubench import weights as W
from gpubench.reference import flamingo as ref
from gpubench.trace import Spans


def process_start_s() -> float:
    """Seconds since this process started, from the kernel's record of its
    start (``/proc/self/stat``, in clock ticks since boot)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


@dataclasses.dataclass
class Run:
    """One run of one cell: what the family reads and what it records for
    the metric readers (``record``)."""

    spec: dict          # the manifest entry merged with its workload file
    sizes: object       # manifest.model_sizes of the configuration file
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    overrides: dict = dataclasses.field(default_factory=dict)  # controls and faults
    spans: Spans = dataclasses.field(default_factory=Spans)
    record: dict = dataclasses.field(default_factory=dict)


def port_config(config: dict, program: dict):
    """The program's model configuration from a configuration file, with
    the cell's activation checkpointing."""
    from unimp_tpu_torch.models.config import LMConfig, ResamplerConfig, UniMPConfig, VisionConfig

    return UniMPConfig(VisionConfig(**config["vision"]), ResamplerConfig(**config["resampler"]),
                       LMConfig(**config["lm"]), cross_attn_every_n=config["cross_attn_every_n"],
                       media_mode=config.get("media_mode", "immediate"),
                       dtype=config.get("dtype", "bfloat16"),
                       remat=program.get("remat", False),
                       remat_policy=program.get("remat_policy", "none"))


def seeded_weights(sizes, seed: int, device) -> dict:
    """{flat path: function} for ``build_model(weights=...)``: each tensor
    drawn on the device when the build asks for it."""
    def one(name, shape):
        return lambda _seeded: W.draw(seed, name, shape, device)

    return {name.replace(".", "/"): one(name, shape)
            for name, shape in ref.param_shapes(sizes).items()}


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)

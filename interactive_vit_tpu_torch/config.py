"""Framework configuration: one flat dataclass, env-var overridable.

The port's copy of ``interactive_vit_tpu/config.py``: the same fields,
defaults and ``IVT_<UPPERCASE_NAME>`` environment overrides. The
node-param contract is carried on the wire (``graph/ir.py``); these are the
framework-level knobs. No served path reads them (as in the JAX package):
the server takes its settings from its command line.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name: str, default, cast):
    raw = os.environ.get(f"IVT_{name.upper()}")
    if raw is None:
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes")
    return cast(raw)


@dataclasses.dataclass
class Config:
    # serving
    host: str = "127.0.0.1"
    port: int = 8000
    max_batch: int = 8
    max_wait_ms: float = 3.0
    models: str = "vit_t16"
    graphs_dir: Optional[str] = None
    frontend_dir: Optional[str] = None
    compute_timeout_s: float = 120.0  # /compute deadline; wedged device -> 503

    # compute
    attn_impl: str = "auto"          # auto | flash | reference
    compute_dtype: str = "bfloat16"  # serving compute dtype
    use_jit: bool = True

    # observability
    profiler_port: int = 0           # 0 = off
    debug_nans: bool = False
    log_level: str = "INFO"

    # native tier
    native: bool = True              # C++ codec fast path

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        for f in dataclasses.fields(cls):
            setattr(cfg, f.name, _env(f.name, getattr(cfg, f.name),
                                      type(getattr(cfg, f.name))
                                      if getattr(cfg, f.name) is not None
                                      else str))
        return cfg

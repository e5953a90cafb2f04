"""The architectures the benchmark serves, one file each: ``arch/<name>.py``,
named by a configuration file's ``"arch"`` key (``"gqa"`` where it has
none), and found by that name as ``metrics/<name>.py`` is.

An architecture module gives these functions of a configuration's
numbers ``cfg`` (a ``configs/<name>.json``):

- ``program_config(cfg)``: the program's ``ModelConfig``, importing the
  program inside the function;
- ``make_params(cfg, seed, *, dtype, device)``: the served weights, made
  on the device from the seed (the conventions of ``weights.py``);
- ``forward_logits(cfg, params, tokens, rows, *, moe_groups=(),
  precision="f32", tally=None)``: the plain float32 reference and its
  fp8 control (the contract of ``reference.forward_logits``);
- ``active_params(cfg)``, ``attn_flops(cfg, keys)``,
  ``kv_bytes_per_token_layer(cfg)``, ``decode_attn_work(cfg, lengths)``,
  ``prefill_attn_work(cfg, start, n)``: the counts ``roofline.py``
  composes;
- ``toy(cfg)``: a changed copy at the CPU tests' widths.

It imports torch and ``mars_bench`` modules at top level, and nothing of
the program. The harness reaches it only through ``module(cfg)``.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
DEFAULT = "gqa"
DIR = "_arch_dir"          # the run tree's arch/ folder (bench.cell_files)

_loaded: Dict[Path, ModuleType] = {}


def module(cfg: Dict) -> ModuleType:
    """``arch/<cfg["arch"]>.py``, in the folder ``cfg[DIR]`` names (the
    tree a run was given), else in this one; each file loaded once."""
    path = Path(cfg.get(DIR, HERE)) / f"{cfg.get('arch', DEFAULT)}.py"
    mod = _loaded.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"mars_bench.arch.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return mod

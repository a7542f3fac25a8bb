"""Model summary (counterpart of pytorch_camvid_tpu/utils/summary.py;
reference utils.visualize_network at utils.py:10-13 adds a TB graph).

The same per-stage parameter table as the JAX package's (conv shapes in
its HWIO order), logged as TB text; and ``dump_program``, the counterpart
of the JAX package's (which writes the jitted step's StableHLO): the
``torch.export`` program of a module's forward, as text.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pytorch_camvid_tpu_torch.ops import library  # noqa: F401 (camvid:: ops)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def summarize_model(model, name: str = "model") -> str:
    """Per-stage parameter table of a port model (its ``spec`` and
    ``block_names``), printable and TB-text-loggable."""
    params = dict(model.named_parameters())
    lines = [f"{name}: {count_params(model):,} parameters"]
    for stage, pairs in model.spec:
        names = [model.block_names(stage, i) for i in range(len(pairs))]
        n = sum(params[blk[k]].numel() for blk in names
                for k in ("w", "b", "scale", "bias"))
        shapes = ", ".join(f"3x3x{cin}x{cout}" for cin, cout in pairs)
        lines.append(f"  {stage:12s} {n:>12,}  convs: {shapes}")
    return "\n".join(lines)


def visualize_network(logger, model, name: str = "model") -> str:
    """TB surface of utils.visualize_network: the summary as text."""
    text = summarize_model(model, name)
    if getattr(logger, "_writer", None) is not None:
        logger._writer.add_text(f"{name}/summary", f"```\n{text}\n```")
    return text


def dump_program(module: nn.Module, args: tuple, path: str) -> str:
    """Write the program of ``module(*args)`` to ``path``: the graph of
    ``torch.export.export`` under ``no_grad``, in which each hand-written
    kernel call is one ``camvid::`` op (``ops/library.py``) and a
    train-mode forward's BatchNorm running-stat updates are buffer
    mutations. The trace runs on fake tensors, so the module's parameters,
    buffers and the kernels' launch counts are left as they were. Costs one
    trace, no kernel launch. Returns ``path``."""
    with torch.no_grad():
        exported = torch.export.export(module, tuple(args), strict=False)
    with open(path, "w") as f:
        f.write(str(exported))
    return path

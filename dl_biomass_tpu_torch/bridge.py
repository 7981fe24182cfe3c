"""flax variables <-> torch ``state_dict`` for the ported ``PointNet2Regressor``.

The flax tree is ``{"params": ..., "batch_stats": ...}`` of arrays (numpy, or
anything ``np.asarray`` takes), with the module names fixed by
``dl_biomass_tpu/models/layers.py:208-215`` (``sa1/mlp/lin0``, ``head/bn1``,
...). The torch names follow the same path:

  ``lin{i}.kernel`` (in, out)  -> ``lin{i}.weight`` (out, in), transposed
  ``lin{i}.bias``              -> ``lin{i}.bias``
  ``bn{i}.scale`` / ``.bias``  -> ``bn{i}.weight`` / ``.bias``
  batch_stats ``bn{i}.mean`` / ``.var`` -> ``bn{i}.running_mean`` / ``.running_var``

``to_flax_variables`` maps a model back, so that a trained port model can be
compared with (or loaded by) the JAX package.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _leaves(val, path)
        else:
            yield path, val


def from_flax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model.load_state_dict`` (strict) from flax variables."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables["params"]):
        arr = np.asarray(leaf, dtype=np.float32)
        if path[-1] not in _PARAM_NAMES:
            raise KeyError(f"unexpected parameter {'/'.join(path)}")
        if path[-1] == "kernel":
            arr = arr.T
        out[".".join(path[:-1] + (_PARAM_NAMES[path[-1]],))] = torch.from_numpy(arr.copy())
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        if path[-1] not in _STAT_NAMES:
            raise KeyError(f"unexpected batch statistic {'/'.join(path)}")
        arr = np.asarray(leaf, dtype=np.float32)
        out[".".join(path[:-1] + (_STAT_NAMES[path[-1]],))] = torch.from_numpy(arr.copy())
    return out


def to_flax_variables(model: torch.nn.Module) -> Dict[str, dict]:
    """``{"params", "batch_stats"}`` nested dicts of float32 numpy arrays from the
    model's ``state_dict``: the inverse of ``from_flax_variables``."""
    inv_param = {"lin": {"weight": "kernel", "bias": "bias"},
                 "bn": {"weight": "scale", "bias": "bias"}}
    inv_stat = {v: k for k, v in _STAT_NAMES.items()}
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        *mods, leaf = name.split(".")
        arr = t.detach().cpu().float().numpy()
        kind = "lin" if mods[-1].startswith("lin") else "bn"
        if leaf in inv_stat:
            tree, key = out["batch_stats"], inv_stat[leaf]
        elif leaf in inv_param[kind]:
            tree, key = out["params"], inv_param[kind][leaf]
            if key == "kernel":
                arr = arr.T
        else:
            raise KeyError(f"unexpected state entry {name}")
        for mod in mods:
            tree = tree.setdefault(mod, {})
        tree[key] = np.ascontiguousarray(arr)
    return out

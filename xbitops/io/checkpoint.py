"""Save/restore packed (quantized) parameter trees.

The reference's only persistence is raw ``.bin`` fixture dumps read from an
absolute path (``main.cc:11-82``).  Here a packed model — a pytree of dicts /
lists / arrays / :class:`~xbitops.formats.QTensor` — round-trips through a
self-describing directory: one ``manifest.json`` for the tree structure and
QTensor static metadata, one ``.npy`` per array leaf.  Conversion from GPTQ
interchange to the plane layout thus happens once, offline; engine startup
just maps the packed planes in.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import jax.numpy as jnp
import numpy as np

from xbitops.formats import QTensor

__all__ = ["save_packed", "load_packed"]

# v2: 4-bit planes switched from the slot layout to the
# PAIRED layout (formats._pack_plane_paired); v1 checkpoints must be
# re-converted from their GPTQ source (conversion is offline and cheap).
# v3: the 4-bit plane of the multi-plane widths (5/6/7-bit) pairs too.
_FORMAT_VERSION = 3


def _encode(node: Any, path: str, arrays: dict) -> dict:
    if isinstance(node, QTensor):
        for i, pln in enumerate(node.planes):
            arrays[f"{path}.plane{i}"] = np.asarray(pln)
        arrays[f"{path}.scales"] = np.asarray(node.scales)
        arrays[f"{path}.scale_zeros"] = np.asarray(node.scale_zeros)
        if node.perm is not None:
            arrays[f"{path}.perm"] = np.asarray(node.perm)
        return {
            "kind": "qtensor",
            "n_planes": len(node.planes),
            "has_perm": node.perm is not None,
            "bits": node.bits,
            "group_size": node.group_size,
            "tile_k": node.tile_k,
            "K": node.K,
            "K_logical": node.K_logical,
            "N_logical": node.N_logical,
            "value_bits": node.value_bits,
        }
    if isinstance(node, dict):
        return {
            "kind": "dict",
            "items": {k: _encode(v, f"{path}.{k}", arrays) for k, v in node.items()},
        }
    if isinstance(node, (list, tuple)):
        return {
            "kind": "list",
            "items": [_encode(v, f"{path}.{i}", arrays) for i, v in enumerate(node)],
        }
    arrays[path] = np.asarray(node)
    return {"kind": "array"}


def _decode(meta: dict, path: str, load_array) -> Any:
    kind = meta["kind"]
    if kind == "qtensor":
        return QTensor(
            planes=tuple(
                load_array(f"{path}.plane{i}") for i in range(meta["n_planes"])
            ),
            scales=load_array(f"{path}.scales"),
            scale_zeros=load_array(f"{path}.scale_zeros"),
            bits=meta["bits"],
            group_size=meta["group_size"],
            tile_k=meta["tile_k"],
            K=meta["K"],
            K_logical=meta["K_logical"],
            perm=load_array(f"{path}.perm") if meta["has_perm"] else None,
            N_logical=meta.get("N_logical"),
            value_bits=meta.get("value_bits"),
        )
    if kind == "dict":
        return {k: _decode(m, f"{path}.{k}", load_array) for k, m in meta["items"].items()}
    if kind == "list":
        return [_decode(m, f"{path}.{i}", load_array) for i, m in enumerate(meta["items"])]
    return load_array(path)


# numpy can't serialize ml_dtypes (bfloat16, fp8...) natively: store the raw
# bits in a same-width integer view and record the true dtype in the manifest.
_VIEW_FOR_WIDTH = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def save_packed(params: Any, path: str, tp: int = 1) -> None:
    """Write a packed parameter pytree to ``path`` (a directory).

    ``tp`` records the tensor-parallel degree the tree was packed for
    (row-sharded QTensors are shard-stacked per ``tp``); :func:`load_packed`
    refuses a mismatched request instead of failing later with an obscure
    shard-shape error."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    arrays: dict = {}
    tree = _encode(params, "p", arrays)
    dtypes = {}
    for name, arr in arrays.items():
        if arr.dtype.kind == "V":  # ml_dtypes (bfloat16, fp8): npy loses identity
            dtypes[name] = str(arr.dtype)
            arr = arr.view(_VIEW_FOR_WIDTH[arr.dtype.itemsize])
        np.save(p / f"{name}.npy", arr, allow_pickle=False)
    (p / "manifest.json").write_text(
        json.dumps(
            {"version": _FORMAT_VERSION, "tp": tp, "tree": tree, "dtypes": dtypes}
        )
    )


def load_packed(path: str, to_device: bool = True, tp: int | None = None) -> Any:
    """Read a packed parameter pytree written by :func:`save_packed`.

    ``tp`` (if given) must equal the degree recorded at pack time — a
    tp=1-packed dir cannot serve a tp=8 mesh and vice versa."""
    import ml_dtypes  # noqa: F401  (registers bfloat16 etc. with numpy)

    p = Path(path)
    manifest = json.loads((p / "manifest.json").read_text())
    if manifest["version"] != _FORMAT_VERSION:
        raise ValueError(f"unknown packed-checkpoint version {manifest['version']}")
    packed_tp = manifest.get("tp", 1)
    if tp is not None and tp != packed_tp:
        raise ValueError(
            f"checkpoint at {path} was packed for tp={packed_tp}, "
            f"requested tp={tp}; re-run convert with --tp {tp}"
        )
    dtypes = manifest.get("dtypes", {})

    def load_array(name: str):
        arr = np.load(p / f"{name}.npy", allow_pickle=False)
        if name in dtypes:
            arr = arr.view(np.dtype(dtypes[name]))
        return jnp.asarray(arr) if to_device else arr

    return _decode(manifest["tree"], "p", load_array)

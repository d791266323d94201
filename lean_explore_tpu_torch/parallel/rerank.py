"""Data-parallel grouped rerank over a device mesh
(lean_explore_tpu/parallel/rerank.py).

Query groups are independent: each group's prefix-KV forward and its
document suffixes touch only its own rows. So the group axis is split
over the mesh's ``data`` devices; each device runs ``qwen3.prefix_kv`` and
``qwen3.rerank_scores_grouped`` on its rows with its own copy of the
params, and the scores are concatenated in group order on the first
device. There is no collective beyond that gather, as in JAX's
``shard_map``.

The retrieval mesh is (data, corpus); rerank wants every device on one
``data`` axis, so ``rerank_data_mesh`` builds a flat view over the same
devices.
"""

import numpy as np
import torch

from lean_explore_tpu_torch.models import qwen3
from lean_explore_tpu_torch.models.qwen3 import Qwen3Config
from lean_explore_tpu_torch.parallel.mesh import Mesh
from lean_explore_tpu_torch.util.platform import mesh_devices


def rerank_data_mesh(source: Mesh | None = None, devices=None) -> Mesh:
    """1D ('data',) mesh over a source mesh's devices (or ``devices``, or
    every device of ``util.platform.mesh_devices``)."""
    if devices is None:
        devices = source.devices.flatten() if source is not None else mesh_devices()
    grid = np.empty(len(devices), dtype=object)
    grid[:] = list(devices)
    return Mesh(grid, ("data",))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree if tree is None else tree.to(device)


def replicate_params(params: dict, mesh: Mesh) -> dict:
    """{device: params there} for each distinct device of the mesh: one
    copy per device, however often the mesh repeats it (a tensor already
    there is not copied)."""
    return {device: _tree_to(params, device) for device in mesh.distinct_devices()}


def make_sharded_grouped_scorer(
    config: Qwen3Config,
    mesh: Mesh,
    *,
    token_true: int,
    token_false: int,
    group_chunk: int,
):
    """Scorer (replicas, prefix_ids [G, P], prefix_mask, suffix_ids
    [G, D, S], suffix_mask, pos_offset [G]) -> [G, D] P(true) on the mesh's
    first device; ``replicas`` is ``replicate_params``' result.

    G must be a multiple of the data size x group_chunk (the caller pads;
    pad groups carry one valid token and their scores are discarded). Each
    device runs the single-device grouped path on its G / data rows.
    """
    devices = list(mesh.devices.flat)
    first = devices[0]

    @torch.no_grad()
    def scorer(replicas, prefix_ids, prefix_mask, suffix_ids, suffix_mask, pos_offset):
        g = prefix_ids.shape[0]
        if g % (len(devices) * group_chunk):
            raise ValueError(
                f"G={g} not a multiple of data={len(devices)} x group_chunk={group_chunk}"
            )
        per = g // len(devices)
        out = []
        for i, device in enumerate(devices):
            rows = slice(i * per, (i + 1) * per)

            def part(array, rows=rows, device=device):
                return torch.as_tensor(np.ascontiguousarray(array[rows])).to(device)

            params = replicas[device]
            pmask = part(prefix_mask)
            pk, pv = qwen3.prefix_kv(params, config, part(prefix_ids), pmask)
            out.append(qwen3.rerank_scores_grouped(
                params, config, pk, pv, pmask, part(suffix_ids), part(suffix_mask),
                part(pos_offset), token_true=token_true, token_false=token_false,
                group_chunk=group_chunk,
            ))
        return out[0] if len(out) == 1 else torch.cat([s.to(first) for s in out])

    return scorer

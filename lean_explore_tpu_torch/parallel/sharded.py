"""Corpus-sharded dense retrieval over a device mesh
(lean_explore_tpu/parallel/sharded.py).

The corpus rows are split over the mesh's ``corpus`` axis, the queries
over its ``data`` axis. Each (data, corpus) position takes the top-k of
its query slice over its shard on its own device: the exact scan for
small shards or off the card, the bin_topk kernel (K1) over a bf16 or
float32 shard or the int8 one (K2) over an int8 shard on the card. Every
shard's work is issued before any result is read back. The candidates
then go to the mesh's first device, where an exact ``torch.topk`` over
the n_shards x k columns merges them: the port's epilogue in place of
JAX's ``all_gather`` and ``lax.approx_max_k`` (ROADMAP C).

One process drives every device, as JAX's single controller does. A mesh
whose device list repeats one device runs each position on it in turn,
with one copy of each shard.
"""

import numpy as np
import torch

from lean_explore_tpu_torch.index.dense import _torch_dtype
from lean_explore_tpu_torch.ops import bin_topk as K1
from lean_explore_tpu_torch.ops import bin_topk_int8 as K2
from lean_explore_tpu_torch.ops.dense import TILE_ROWS, _scores, l2_normalize
from lean_explore_tpu_torch.ops.quant import quantize_rows
from lean_explore_tpu_torch.parallel.mesh import Mesh

NEG_INF = float("-inf")

# Above this many rows a shard takes the kernel (``auto``), as
# ops.dense.dense_topk does over one corpus.
KERNEL_MIN_SHARD_ROWS = 16384


def _pad_local_k(s, pos, k: int, local_k: int):
    """Pad a [B, local_k] selection to [B, k] so the shards' candidates
    line up for the merge."""
    if local_k < k:
        s = torch.nn.functional.pad(s, (0, k - local_k), value=NEG_INF)
        pos = torch.nn.functional.pad(pos, (0, k - local_k))
    return s, pos


def _local_topk_chunked(q, shard, row_offset: int, n_valid: int, k: int, chunk: int):
    """Exact top-k over one shard in chunks of ``chunk`` rows; indices are
    global rows. A row is valid below the global ``n_valid``."""
    batch, rows = q.shape[0], shard.shape[0]
    chunk = min(chunk, rows)
    best_s = torch.full((batch, k), NEG_INF, device=shard.device)
    best_i = torch.zeros((batch, k), dtype=torch.int32, device=shard.device)
    for start in range(0, rows, chunk):
        scores = _scores(q, shard[start : start + chunk])
        col = row_offset + start + torch.arange(scores.shape[1], device=shard.device)
        scores = scores.masked_fill(col[None, :] >= n_valid, NEG_INF)
        ts, tp = torch.topk(scores, min(k, scores.shape[1]), dim=1)
        cs = torch.cat([best_s, ts], dim=1)
        ci = torch.cat([best_i, (row_offset + start + tp).to(torch.int32)], dim=1)
        best_s, pos = torch.topk(cs, k, dim=1)
        best_i = torch.gather(ci, 1, pos)
    return best_s, best_i


def _local_full_topk(q, shard, row_offset: int, n_valid: int, *, k: int):
    """Exact one-product top-k over one shard: the ``approx`` method (JAX's
    ``approx_max_k`` is exact off a TPU) and the kernels' k > bins
    fallback (ops.dense.dense_topk's full-scan escape)."""
    rows = shard.shape[0]
    scores = _scores(q, shard)
    col = row_offset + torch.arange(rows, device=shard.device)
    scores = scores.masked_fill(col[None, :] >= n_valid, NEG_INF)
    local_k = min(k, rows)
    s, pos = torch.topk(scores, local_k, dim=1)
    s, pos = _pad_local_k(s, pos, k, local_k)
    # -inf candidates (masked rows that a shard with few valid rows still
    # selects) carry global index 0, so no merge can surface a pad row.
    idx = torch.where(s == NEG_INF, 0, row_offset + pos.to(torch.int32))
    return s, idx.to(torch.int32)


def _shard_bins(rows: int, batch: int) -> int:
    """The kernels' bin count for one shard, the JAX package's: 4096,
    halved while the packed carry and output (bins x B x 8 bytes) pass 8 MB
    or bins pass the shard, never below 1024 (a multiple of 64, which the
    port's kernels take)."""
    bins = 4096
    local_batch = max(batch, 8)
    while bins * local_batch * 8 > 8 * 1024 * 1024 and bins > 1024:
        bins //= 2
    while bins > rows and bins > 1024:
        bins //= 2
    return bins


def _local_topk_fused_common(kernel, q, rows: int, row_offset: int, n_valid: int, *, k):
    """The kernels' per-shard selection: bins, the local-k padding, and the
    packed-zero sentinels of pad rows (they unpack to -3.0; real scores are
    >= -1) masked to -inf with global index 0, the JAX package's fix.
    ``kernel(local_valid, local_k, bins)`` returns (scores, local rows).
    Returns None where k > bins (the caller takes the exact scan)."""
    local_k = min(k, rows)
    local_valid = min(max(n_valid - row_offset, 0), rows)
    bins = _shard_bins(rows, q.shape[0])
    if local_k > bins:
        return None
    s, pos = kernel(local_valid, local_k, bins)
    s, pos = _pad_local_k(s, pos, k, local_k)
    sentinel = s <= -2.0
    s = s.masked_fill(sentinel, NEG_INF)
    idx = torch.where(sentinel, torch.zeros_like(pos), row_offset + pos)
    return s, idx.to(torch.int32)


def _local_topk_fused(q, shard, row_offset: int, n_valid: int, *, k: int):
    """K1 over one bf16 or float32 shard (its plain twin on the CPU)."""

    def kernel(local_valid, local_k, bins):
        return K1.bin_topk(q, shard, local_valid, k=local_k, bins=bins)

    out = _local_topk_fused_common(kernel, q, shard.shape[0], row_offset, n_valid, k=k)
    if out is None:
        return _local_full_topk(q, shard, row_offset, n_valid, k=k)
    return out


def _local_topk_fused_int8(q, codes, scales, row_offset: int, n_valid: int, *, k: int):
    """K2 over one int8 shard's codes and row scales (its plain twin on the
    CPU); k > bins takes the exact scan over the dequantized shard."""

    def kernel(local_valid, local_k, bins):
        return K2.bin_topk_int8(q, codes, scales, local_valid, k=local_k, bins=bins)

    out = _local_topk_fused_common(kernel, q, codes.shape[0], row_offset, n_valid, k=k)
    if out is None:
        shard = codes.to(torch.float32) * scales[:, None]
        return _local_full_topk(q, shard, row_offset, n_valid, k=k)
    return out


def make_sharded_topk(mesh: Mesh, *, k: int, chunk: int = 8192, method: str = "chunked"):
    """The sharded top-k of a mesh.

    Returns fn(queries [B, D], shards, n_valid) -> (scores [B, k], global
    rows [B, k]) on the mesh's first device, where B is a multiple of the
    ``data`` axis and ``shards[d, c]`` is corpus shard c on
    ``mesh.devices[d, c]`` (``place_shards``). Methods: "chunked" (exact
    scan in chunks), "approx" (exact one-product scan), "fused" (K1) and
    "fused_int8" (K2), whose fn takes (queries, codes, scales, n_valid).
    """
    n_data, n_corpus = mesh.devices.shape
    first = mesh.devices.flat[0]

    def local(q, shard, scales, row_offset, n_valid):
        if method == "fused_int8":
            return _local_topk_fused_int8(q, shard, scales, row_offset, n_valid, k=k)
        if method == "fused":
            return _local_topk_fused(q, shard, row_offset, n_valid, k=k)
        if method == "approx":
            return _local_full_topk(q, shard, row_offset, n_valid, k=k)
        return _local_topk_chunked(q, shard, row_offset, n_valid, k, chunk)

    def fn(queries, shards, *rest):
        scales, n_valid = rest if method == "fused_int8" else (None, rest[0])
        n_valid = int(n_valid)
        if queries.shape[0] % n_data:
            raise ValueError(f"batch {queries.shape[0]} not a multiple of data={n_data}")
        per = queries.shape[0] // n_data
        rows = shards[0, 0].shape[0]
        # Issue every position's selection before any is read back.
        candidates = []
        for d in range(n_data):
            sliced = {}
            for c in range(n_corpus):
                device = mesh.devices[d, c]
                if device not in sliced:
                    sliced[device] = queries[d * per : (d + 1) * per].to(device)
                candidates.append(local(
                    sliced[device], shards[d, c],
                    None if scales is None else scales[d, c], c * rows, n_valid,
                ))
        out_s, out_i = [], []
        for d in range(n_data):
            row = candidates[d * n_corpus : (d + 1) * n_corpus]
            all_s = torch.cat([s.to(first) for s, _ in row], dim=1)
            all_i = torch.cat([i.to(first) for _, i in row], dim=1)
            best_s, pos = torch.topk(all_s, k, dim=1)
            out_s.append(best_s)
            out_i.append(torch.gather(all_i, 1, pos))
        return torch.cat(out_s), torch.cat(out_i)

    return fn


def place_shards(shards: list[torch.Tensor], mesh: Mesh) -> np.ndarray:
    """[data, corpus] object array: shard c on each device of column c of
    the mesh (replicated over ``data``), one copy per distinct device."""
    placed = np.empty(mesh.devices.shape, dtype=object)
    copies: dict = {}
    for (d, c), device in np.ndenumerate(mesh.devices):
        key = (c, device)
        if key not in copies:
            copies[key] = shards[c].to(device)
        placed[d, c] = copies[key]
    return placed


class ShardedDenseIndex:
    """Mesh-sharded inner-product index.

    The corpus matrix is padded so its rows split evenly over the
    ``corpus`` axis (and, for the kernel methods, each shard's rows to a
    multiple of 512), normalized on the host and placed shard by shard.
    ``search`` is exact for "chunked" and "approx"; the kernel methods
    carry the bin-max survivorship of ``ops.dense.dense_topk``'s kernel
    path.
    """

    def __init__(
        self,
        embeddings: np.ndarray,
        ids: np.ndarray,
        mesh: Mesh,
        *,
        dtype: str = "float32",
        chunk: int = 8192,
        method: str = "auto",
    ):
        if embeddings.shape[0] != len(ids):
            raise ValueError("ids length must match embedding rows")
        self.mesh = mesh
        self.ids = np.asarray(ids, dtype=np.int64)
        self.n = int(embeddings.shape[0])
        self.dim = int(embeddings.shape[1])
        self.chunk = chunk

        n_corpus = mesh.shape["corpus"]
        int8 = str(dtype) == "int8"
        if int8:
            method = "fused_int8"
        if method == "auto":
            shard_rows = -(-self.n // n_corpus)
            if shard_rows <= KERNEL_MIN_SHARD_ROWS:
                method = "chunked"
            elif mesh.devices.flat[0].type == "cuda":
                method = "fused"
            else:
                method = "approx"
        self.method = method
        align = n_corpus * (TILE_ROWS if method in ("fused", "fused_int8") else 1)
        padded = max(-(-self.n // align) * align, align)
        mat = np.zeros((padded, self.dim), dtype=np.float32)
        mat[: self.n] = np.asarray(embeddings, dtype=np.float32)
        norms = np.linalg.norm(mat[: self.n], axis=1, keepdims=True)
        mat[: self.n] /= np.maximum(norms, 1e-12)
        self.shard_rows = padded // n_corpus

        def split(array: np.ndarray) -> list[torch.Tensor]:
            return list(torch.from_numpy(array).split(self.shard_rows))

        self.scales = None  # [data, corpus] placed row scales of an int8 index
        if int8:
            codes, scales = quantize_rows(mat[: self.n])
            pad = padded - self.n
            if pad:  # zero pad rows quantize to zero codes; their scale is moot
                codes = np.pad(codes, ((0, pad), (0, 0)))
                scales = np.pad(scales, (0, pad), constant_values=1.0)
            self.shards = place_shards(split(codes), mesh)
            self.scales = place_shards(split(scales.astype(np.float32)), mesh)
        else:
            torch_dtype = _torch_dtype(dtype)
            self.shards = place_shards([s.to(torch_dtype) for s in split(mat)], mesh)
        self._topk_fns: dict[int, object] = {}

    def search(self, query_embeddings, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Top-k across every shard: (scores [B, k] float32, declaration ids
        [B, k] int64)."""
        k = min(k, self.n)
        q = l2_normalize(torch.as_tensor(query_embeddings).to(torch.float32))
        n_data = self.mesh.shape["data"]
        batch = q.shape[0]
        padded = -(-batch // n_data) * n_data
        if padded != batch:
            q = torch.nn.functional.pad(q, (0, 0, 0, padded - batch))
        fn = self._topk_fns.get(k)
        if fn is None:
            fn = make_sharded_topk(self.mesh, k=k, chunk=self.chunk, method=self.method)
            self._topk_fns[k] = fn
        if self.scales is not None:
            scores, idx = fn(q, self.shards, self.scales, self.n)
        else:
            scores, idx = fn(q, self.shards, self.n)
        scores = scores[:batch].cpu().numpy()
        idx = idx[:batch].cpu().numpy()
        return scores, self.ids[idx]

    def row_embeddings(self) -> np.ndarray:
        """Host copy of the unpadded matrix in float32 (an int8 index
        dequantizes), ``DenseIndex.row_embeddings``'s."""
        rows = [s.to(torch.float32) for s in self.shards[0]]
        if self.scales is not None:
            rows = [r * s[:, None] for r, s in zip(rows, self.scales[0])]
        return torch.cat([r.cpu() for r in rows])[: self.n].numpy()

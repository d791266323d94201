"""Device-resident dense retrieval index, the counterpart of
lean_explore_tpu/index/dense.py.

The artifact is an L2-normalized float32 matrix plus a row -> declaration id
map. At load time the matrix goes to the device in the serving dtype
(bfloat16 by default: it halves the bytes of the retrieval pass, which bound
it), padded once to a multiple of ROW_ALIGN rows so the search never copies
it again. ``dtype="int8"`` quantizes each row (ops/quant.py): int8 codes
plus f32 row scales, half the bytes of bfloat16, searched on the card by
the hand-written int8 bin_topk kernel (ops/bin_topk_int8.py).
"""

from pathlib import Path

import numpy as np
import torch

from lean_explore_tpu_torch.models.tokenizer import bucket_batch
from lean_explore_tpu_torch.ops.bin_topk_int8 import bin_topk_int8
from lean_explore_tpu_torch.ops.dense import (
    METHODS,
    dense_topk,
    l2_normalize,
    serving_bins,
)
from lean_explore_tpu_torch.ops.quant import quantize_rows, quantized_topk
from lean_explore_tpu_torch.util.platform import resolve_device

EMBEDDINGS_FILE = "dense_embeddings.npy"
IDS_FILE = "dense_ids.npy"

# Rows are padded to this multiple ONCE at construction; pad rows are
# masked by n_valid at search time.
ROW_ALIGN = 512

# The int8 kernel path runs only above this many padded rows; below it the
# exact scan is cheap (lean_explore_tpu/index/dense.py:181).
INT8_KERNEL_MIN_ROWS = 16384

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _torch_dtype(dtype: str | torch.dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) not in _DTYPES:
        raise ValueError(
            f"corpus dtype {dtype!r} is not served by this package "
            f"(have {sorted(_DTYPES)})"
        )
    return _DTYPES[str(dtype)]


def require_dense_artifacts(directory: str | Path) -> tuple[Path, Path]:
    """(embeddings_path, ids_path); raises a guided FileNotFoundError."""
    directory = Path(directory)
    emb_path = directory / EMBEDDINGS_FILE
    ids_path = directory / IDS_FILE
    for p in (emb_path, ids_path):
        if not p.exists():
            raise FileNotFoundError(
                f"Dense index artifact missing: {p}. Run 'lean-explore data "
                "fetch' or the extraction pipeline first."
            )
    return emb_path, ids_path


class DenseIndex:
    """Inner-product index over normalized embeddings on one device."""

    def __init__(self, embeddings: torch.Tensor, ids, *, normalized: bool = True):
        """Wrap an embedding matrix already on its device.

        Args:
            embeddings: [N, D] (rows L2-normalized when normalized=True).
            ids: [N] declaration ids for each row.
            normalized: Set False to normalize here.
        """
        if embeddings.ndim != 2:
            raise ValueError("embeddings must be [N, D]")
        if embeddings.shape[0] != len(ids):
            raise ValueError("ids length must match embedding rows")
        if not normalized:
            embeddings = l2_normalize(embeddings)
        self.n = int(embeddings.shape[0])
        self.dim = int(embeddings.shape[1])
        padded = -(-self.n // ROW_ALIGN) * ROW_ALIGN
        if padded != self.n:
            embeddings = torch.nn.functional.pad(
                embeddings, (0, 0, 0, padded - self.n)
            )
        self.embeddings = embeddings.contiguous()
        self.scales = None  # [padded rows] f32, set for int8-quantized indices
        self.ids = np.asarray(ids, dtype=np.int64)

    @property
    def device(self) -> torch.device:
        return self.embeddings.device

    @classmethod
    def build(
        cls,
        embeddings: np.ndarray,
        ids: np.ndarray,
        *,
        dtype: str | torch.dtype = "float32",
        device: str | torch.device | None = None,
    ) -> "DenseIndex":
        """Normalize in f32 on the host and place in the serving dtype.

        dtype "int8" quantizes per row on the host (ops/quant.py); pad rows
        get zero codes and scale 1.
        """
        device = resolve_device(device)
        torch_dtype = _torch_dtype(dtype)
        mat = np.asarray(embeddings, dtype=np.float32)
        mat = mat / np.maximum(np.linalg.norm(mat, axis=1, keepdims=True), 1e-12)
        if torch_dtype != torch.int8:
            tensor = torch.from_numpy(mat).to(device=device, dtype=torch_dtype)
            return cls(tensor, ids, normalized=True)
        codes, scales = quantize_rows(mat)
        index = cls(torch.from_numpy(codes).to(device), ids, normalized=True)
        pad = index.embeddings.shape[0] - len(scales)
        scales = np.pad(scales, (0, pad), constant_values=1.0)
        index.scales = torch.from_numpy(scales).to(device)
        return index

    @classmethod
    def load(
        cls,
        directory: str | Path,
        *,
        dtype: str | torch.dtype = "float32",
        device: str | torch.device | None = None,
    ) -> "DenseIndex":
        emb_path, ids_path = require_dense_artifacts(directory)
        mat, ids = np.load(emb_path), np.load(ids_path)
        if _torch_dtype(dtype) == torch.int8:
            return cls.build(mat, ids, dtype="int8", device=device)
        tensor = torch.from_numpy(mat).to(
            device=resolve_device(device), dtype=_torch_dtype(dtype)
        )
        return cls(tensor, ids, normalized=True)

    def save(self, directory: str | Path) -> None:
        """Write the artifact pair: always float32 on disk, the first ``n``
        rows only (an int8 index dequantizes its codes by their row
        scales); the serving dtype is a load-time choice."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        np.save(directory / EMBEDDINGS_FILE, self.row_embeddings())
        np.save(directory / IDS_FILE, self.ids)

    def row_embeddings(self) -> np.ndarray:
        """Host copy of the unpadded matrix in float32 (int8 dequantizes)."""
        mat = self.embeddings.to(torch.float32)
        if self.scales is not None:
            mat = mat * self.scales[:, None]
        return mat[: self.n].cpu().numpy()

    def search(
        self,
        query_embeddings: torch.Tensor | np.ndarray,
        k: int,
        *,
        method: str = "auto",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k for a batch of queries.

        Args:
            query_embeddings: [B, D]; a tensor on the index's device is
                used where it lies (the encoder's output needs no host
                copy). Normalized here for safety.
            k: neighbors per query (clamped to corpus size).
            method: ops.dense.dense_topk method. An int8 index takes its
                kernel for "auto"/"fused_pallas" on the card above
                INT8_KERNEL_MIN_ROWS padded rows when k <= bins, and the
                exact quantized scan otherwise.

        Returns:
            (scores [B, k] float32 np, declaration_ids [B, k] int64 np).
        """
        q = torch.as_tensor(query_embeddings, device=self.device)
        q = l2_normalize(q.to(torch.float32))
        k = min(k, self.n)
        # Pad the batch to the standard buckets, as the JAX index does, so
        # the kernel sees the same few batch shapes whatever the request.
        b_valid = int(q.shape[0])
        b_padded = bucket_batch(b_valid)
        if b_padded != b_valid:
            q = torch.nn.functional.pad(q, (0, 0, 0, b_padded - b_valid))
        if self.scales is not None:
            scores, rows = self._search_int8(q, k, method)
        else:
            scores, rows = dense_topk(
                q, self.embeddings, k, n_valid=self.n, method=method
            )
        rows = rows[:b_valid].cpu().numpy()
        scores = scores[:b_valid].cpu().numpy()
        return scores, self.ids[rows]

    def _search_int8(
        self, q: torch.Tensor, k: int, method: str
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The JAX index's int8 dispatch (lean_explore_tpu/index/dense.py:
        177-214) with the CUDA device in place of the TPU backend."""
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r} (have {METHODS})")
        rows_padded = self.embeddings.shape[0]
        if (
            method in ("auto", "fused_pallas")
            and self.device.type == "cuda"
            and rows_padded > INT8_KERNEL_MIN_ROWS
        ):
            bins = serving_bins(q.shape[0], rows_padded)
            if k <= bins:
                return bin_topk_int8(
                    q, self.embeddings, self.scales, self.n, k=k, bins=bins
                )
        return quantized_topk(q, self.embeddings, self.scales, self.n, k=k)

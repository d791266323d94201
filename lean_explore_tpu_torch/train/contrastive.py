"""Contrastive (InfoNCE) fine-tuning of the Qwen3 embedder on one device
or a (data, model) mesh of processes, the counterpart of
lean_explore_tpu/train/contrastive.py.

In-batch negatives: query i's positive is document i, every other document
in the global batch is a negative, except documents with the same text as
i's (``doc_dup_mask``).

On a mesh (``parallel.mesh.init_distributed``, one process per position)
the step computes what JAX's GSPMD step computes, spelled out:

- ``model`` (tensor parallelism, ``param_partition_specs``): each rank
  holds whole heads and MLP columns, q/k/v/gate/up split by columns and
  o/down by rows (``shard_params``); the trunk sums the row-split products
  over the model group (``parallel.collectives.TensorParallel``). Norms
  and the tied embedding are replicated; q_norm and k_norm act on the
  rank's heads only, so their gradients are summed over the model group.
- ``data``: every rank is given the same global batch and takes its own
  B / data rows. The pooled query and document embeddings are gathered
  over the data group (``gather_rows``, whose backward keeps this rank's
  rows) and InfoNCE runs over the global batch on every rank alike. Each
  rank's gradient is then its rows' share of the global loss's gradient,
  so the gradients are SUMMED over the data group: the sum is the global
  batch's gradient, GSPMD's. (A mean would divide it by the data size;
  a gather whose backward sums over ranks, as ``torch.distributed.nn``'s
  does, would multiply each share by it.)
- AdamW is elementwise, so each rank's moments are the global ones'
  slices.

Parameters are the trunk's dict of tensors (``models.qwen3``), each leaf a
leaf tensor with ``requires_grad``. The PyTorch idiom replaces JAX's pure
update: the optimizer state is a ``torch.optim.AdamW`` bound to those
tensors, and a train step updates both in place and returns them. A
learning-rate schedule (``warmup_cosine_decay_schedule``, or any
``count -> lr``) is read at the optimizer's own step count before each
update, as optax reads it at its state's count.
"""

import math
from collections.abc import Callable
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from lean_explore_tpu_torch.models import qwen3
from lean_explore_tpu_torch.models.qwen3 import Qwen3Config
from lean_explore_tpu_torch.parallel.collectives import (
    all_reduce_many,
    gather_dim,
    gather_rows,
    tensor_parallel,
)
from lean_explore_tpu_torch.util.platform import resolve_device


class ContrastiveBatch(NamedTuple):
    """One training batch of (query, positive-document) pairs."""

    query_ids: torch.Tensor  # [B, Tq] int32
    query_mask: torch.Tensor  # [B, Tq] int32
    doc_ids: torch.Tensor  # [B, Td] int32
    doc_mask: torch.Tensor  # [B, Td] int32
    # True at [i, j] (i != j) when doc_j is the same text as doc_i: several
    # queries per document (name and title) can put duplicate positives in
    # one batch, which InfoNCE must not count as negatives.
    doc_dup_mask: torch.Tensor  # [B, B] bool

    def to(self, device) -> "ContrastiveBatch":
        return ContrastiveBatch(*(x.to(device) for x in self))


def leaf_paths(params: dict) -> list[tuple[str, ...]]:
    """The keys of each parameter tensor in a fixed order: embed, the layer
    stacks by name, final_norm, lm_head when untied. The optimizer, the
    checkpoint and the JAX state converter all use this order."""
    paths = [("embed",)] + [("layers", name) for name in sorted(params["layers"])]
    paths.append(("final_norm",))
    if params.get("lm_head") is not None:
        paths.append(("lm_head",))
    return paths


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The parameter tensors in ``leaf_paths`` order."""
    return [_at(params, path) for path in leaf_paths(params)]


def _at(tree: dict, path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _with_leaves(params: dict, leaves: list) -> dict:
    """A params dict of the same keys holding ``leaves`` (``leaf_paths``
    order)."""
    out = {"embed": None, "layers": {}, "final_norm": None, "lm_head": None}
    for path, leaf in zip(leaf_paths(params), leaves):
        if len(path) == 2:
            out["layers"][path[1]] = leaf
        else:
            out[path[0]] = leaf
    return out


# JAX's PartitionSpecs (lean_explore_tpu/train/contrastive.py:29-48) as
# tuples by ``leaf_paths`` path: the position of "model" is the dimension
# split over the model axis; a spec without it is replicated.
_SPECS = {
    ("embed",): (None, None),
    ("layers", "input_norm"): (None, None),
    ("layers", "q_proj"): (None, None, "model"),
    ("layers", "k_proj"): (None, None, "model"),
    ("layers", "v_proj"): (None, None, "model"),
    ("layers", "o_proj"): (None, "model", None),
    ("layers", "q_norm"): (None, None),
    ("layers", "k_norm"): (None, None),
    ("layers", "post_norm"): (None, None),
    ("layers", "gate_proj"): (None, None, "model"),
    ("layers", "up_proj"): (None, None, "model"),
    ("layers", "down_proj"): (None, "model", None),
    ("final_norm",): (None,),
    ("lm_head",): (None, "model"),
}
# Replicated leaves applied to this rank's heads only: their gradients are
# partial sums over the model group.
_PER_HEAD_LEAVES = (("layers", "q_norm"), ("layers", "k_norm"))


def param_partition_specs(config: Qwen3Config) -> dict:
    """The tensor-parallel layout over ``model``, JAX's specs as tuples:
    q/k/v/gate/up split by columns, o/down by rows, an untied lm_head by
    columns; norms and the embedding replicated (lm_head None when tied)."""
    return {
        "embed": _SPECS[("embed",)],
        "layers": {path[1]: spec for path, spec in _SPECS.items() if len(path) == 2},
        "final_norm": _SPECS[("final_norm",)],
        "lm_head": None if config.tie_word_embeddings else _SPECS[("lm_head",)],
    }


def split_dims(params: dict) -> list[int | None]:
    """Per ``leaf_paths`` leaf, the dimension split over ``model``, or None."""
    return [
        _SPECS[path].index("model") if "model" in _SPECS[path] else None
        for path in leaf_paths(params)
    ]


def _model_coord(mesh) -> tuple[int, int]:
    """(model size, this rank's model index) of a mesh, or (1, 0)."""
    if mesh is None:
        return 1, 0
    size = mesh.shape.get("model", 1)
    return size, (mesh.coords or {}).get("model", 0)


def commit_to_mesh(params: dict, mesh) -> dict:
    """Every leaf as a trainable leaf tensor on this rank's mesh device
    (JAX's re-places single-device leaves mesh-replicated)."""
    return _with_leaves(params, [
        leaf.detach().to(mesh.device).contiguous().requires_grad_(True)
        for leaf in param_leaves(params)
    ])


def shard_params(params: dict, mesh, config: Qwen3Config) -> dict:
    """This rank's shard of full ``params`` (``param_partition_specs``),
    trainable on its mesh device. Raises where ``model`` does not divide
    the KV heads (each rank holds whole heads, grouped as GQA groups them),
    the MLP width or an untied vocabulary."""
    model, m = _model_coord(mesh)
    for name, size in (
        ("num_key_value_heads", config.num_key_value_heads),
        ("intermediate_size", config.intermediate_size),
        ("vocab_size", config.vocab_size if params.get("lm_head") is not None else 0),
    ):
        if size % model:
            raise ValueError(f"model axis {model} does not divide {name}={size}")
    leaves = []
    for leaf, dim in zip(param_leaves(params), split_dims(params)):
        if dim is not None and model > 1:
            n = leaf.shape[dim] // model
            leaf = leaf.narrow(dim, m * n, n)
        leaves.append(leaf)
    return commit_to_mesh(_with_leaves(params, leaves), mesh)


def gather_leaves(tensors: list[torch.Tensor], params: dict, mesh) -> list[torch.Tensor]:
    """Tensors shaped like this rank's ``param_leaves`` (the leaves, their
    gradients or moments) made whole over the model group, detached."""
    model, _ = _model_coord(mesh)
    return [
        t.detach() if dim is None or model == 1
        else gather_dim(t.detach().contiguous(), dim, mesh.groups["model"])
        for t, dim in zip(tensors, split_dims(params))
    ]


def local_rows(batch, mesh, *, keep_last: bool = False):
    """This rank's B / data rows of a global batch (the last field whole
    when ``keep_last``: InfoNCE's [B, B] duplicate mask). Raises where the
    data axis does not divide B."""
    data = 1 if mesh is None else mesh.shape.get("data", 1)
    if data == 1:
        return batch
    rows = batch[0].shape[0]
    if rows % data:
        raise ValueError(f"batch size {rows} is not a multiple of the data axis {data}")
    per = rows // data
    d = mesh.coords["data"]
    fields = [x[d * per : (d + 1) * per] for x in batch]
    if keep_last:
        fields[-1] = batch[-1]
    return type(batch)(*fields)


def reduce_gradients(params: dict, mesh, *, mean: bool) -> None:
    """Make each rank's gradients the global step's: q_norm and k_norm
    summed over the model group, then every gradient summed over the data
    group, or averaged when the loss is a mean over each rank's rows."""
    if mesh is None:
        return
    model, _ = _model_coord(mesh)
    if model > 1:
        all_reduce_many(
            [_at(params, p).grad for p in _PER_HEAD_LEAVES], mesh.groups["model"]
        )
    data = mesh.shape.get("data", 1)
    if data > 1:
        grads = [leaf.grad for leaf in param_leaves(params) if leaf.grad is not None]
        all_reduce_many(grads, mesh.groups["data"])
        if mean:
            for g in grads:
                g.div_(data)


def infonce_loss(
    params: dict,
    config: Qwen3Config,
    batch: ContrastiveBatch,
    temperature: float = 0.05,
    *,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    """Symmetric InfoNCE with in-batch negatives, duplicate-positive
    columns at -1e9: (loss, {"loss", "accuracy"}), as the JAX function.
    On a mesh, ``batch`` holds this rank's rows and the global duplicate
    mask, and the loss is the global batch's (module docstring)."""
    tp = tensor_parallel(mesh)
    q = qwen3.embed_pool(params, config, batch.query_ids, batch.query_mask, tp=tp)
    d = qwen3.embed_pool(params, config, batch.doc_ids, batch.doc_mask, tp=tp)
    if mesh is not None:
        q = gather_rows(q, mesh.groups.get("data"))
        d = gather_rows(d, mesh.groups.get("data"))
    logits = (q @ d.T) / temperature  # [B, B] f32
    logits = logits.masked_fill(batch.doc_dup_mask.to(torch.bool), -1e9)
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))
    accuracy = (logits.argmax(dim=1) == labels).float().mean()
    return loss, {"loss": loss.detach(), "accuracy": accuracy}


Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
) -> Schedule:
    """``count -> lr`` with ``optax.warmup_cosine_decay_schedule``'s values
    (exponent 1): linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps`` counts, then a cosine from ``peak_value`` to
    ``end_value`` over ``decay_steps - warmup_steps``, then ``end_value``,
    each step rounded to float32 as optax rounds it (its f32 warmup is
    7.6e-6 off the exact rate at count 1 of 200)."""
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError(
            f"the cosine decay needs decay_steps > warmup_steps, got "
            f"{decay_steps=} and {warmup_steps=}"
        )
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        count = max(int(count), 0)
        if count < warmup_steps:
            frac = f32(1.0) - f32(count) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        t = f32(min(count - warmup_steps, cosine_steps))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * t / f32(cosine_steps)))
        return float(f32(peak_value) * (f32(1.0 - alpha) * cosine + f32(alpha)))

    return schedule


@dataclass(frozen=True)
class AdamW:
    """``make_optimizer``'s result: builds a ``torch.optim.AdamW`` over a
    params dict. optax.adamw and torch's AdamW take the same step: moments
    mu = b1 mu + (1 - b1) g and nu = b2 nu + (1 - b2) g^2, bias-corrected
    by 1 - b^count, and p -= lr (mu_hat / (sqrt(nu_hat) + eps) + wd p) with
    the decay on every leaf and on the pre-update p (torch scales p by
    1 - lr wd first, the same value). A scheduled rate is kept on the
    optimizer as ``lr_schedule`` (not in its ``state_dict``) for
    ``apply_schedule``."""

    learning_rate: float | Schedule = 1e-5
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __call__(self, params: dict) -> torch.optim.AdamW:
        schedule = self.learning_rate if callable(self.learning_rate) else None
        opt_state = torch.optim.AdamW(
            param_leaves(params),
            lr=schedule(0) if schedule else self.learning_rate,
            betas=(self.b1, self.b2),
            eps=self.eps,
            weight_decay=self.weight_decay,
        )
        opt_state.lr_schedule = schedule
        return opt_state


def make_optimizer(
    learning_rate: float | Schedule = 1e-5, weight_decay: float = 0.01
) -> AdamW:
    """AdamW with optax's defaults (betas 0.9/0.999, eps 1e-8, decay on
    every leaf), as the JAX package's ``optax.adamw(lr, weight_decay=wd)``;
    ``learning_rate`` is a float or a schedule ``count -> lr``."""
    return AdamW(learning_rate, weight_decay)


def update_count(opt_state: torch.optim.Optimizer) -> int:
    """The number of updates the optimizer has taken: Adam's ``step`` of
    its first parameter (0 before the first update). A state carried from
    optax (``opt_state_from_optax``) or restored from a checkpoint carries
    it."""
    for group in opt_state.param_groups:
        for leaf in group["params"]:
            state = opt_state.state.get(leaf)
            if state and "step" in state:
                return int(state["step"])
    return 0


def apply_schedule(opt_state: torch.optim.Optimizer) -> None:
    """Set each param group's ``lr`` to the schedule at ``update_count``,
    as optax's ``scale_by_schedule`` reads its count before incrementing
    it: the first update runs at ``schedule(0)``. The decoupled decay is
    scaled by that rate on both sides (torch's ``p *= 1 - lr wd``). No-op
    for a float rate."""
    schedule = getattr(opt_state, "lr_schedule", None)
    if schedule is None:
        return
    lr = float(schedule(update_count(opt_state)))
    for group in opt_state.param_groups:
        group["lr"] = lr


def make_train_step(config: Qwen3Config, temperature: float = 0.05, *, mesh=None):
    """Train step (params, opt_state, batch) -> (params, opt_state, metrics).

    ``opt_state`` is the ``torch.optim.AdamW`` that ``make_optimizer``'s
    result built over ``params`` and holds the hyperparameters (the JAX
    step takes the optax transformation for them instead). The step sets
    the scheduled rate (``apply_schedule``), takes the loss's gradient by
    autograd and lets the optimizer update the params and its moments in
    place, so it returns the objects it was given; metrics are detached
    scalars. On a ``mesh`` (``parallel.mesh.init_distributed``) ``params``
    is this rank's shard (``shard_params``), every rank is given the same
    global batch, and the gradients are summed over the data group (module
    docstring).
    """

    def step(params, opt_state, batch: ContrastiveBatch):
        apply_schedule(opt_state)
        opt_state.zero_grad(set_to_none=True)
        local = local_rows(batch, mesh, keep_last=True)
        loss, metrics = infonce_loss(params, config, local, temperature, mesh=mesh)
        loss.backward()
        reduce_gradients(params, mesh, mean=False)
        opt_state.step()
        return params, opt_state, metrics

    return step


def trainable(params: dict) -> dict:
    """The params with every leaf a leaf tensor that requires grad."""
    for leaf in param_leaves(params):
        leaf.requires_grad_(True)
    return params


def init_train_state(
    config: Qwen3Config,
    optimizer: AdamW,
    *,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
    draw: str = "torch",
    mesh=None,
):
    """Random-init params on ``device`` (CUDA unless the caller asks for
    the CPU) and the matching optimizer state. ``draw`` "torch" draws
    ``qwen3.init_params`` from a ``torch.Generator`` seeded with ``seed``
    on ``device``; "threefry" draws the JAX package's init at ``seed``
    (``qwen3.init_params_threefry``). On a ``mesh`` every rank draws the
    whole init on its device and keeps its shard (``shard_params``)."""
    device = mesh.device if mesh is not None else resolve_device(device)
    if draw == "torch":
        generator = torch.Generator(device=device).manual_seed(seed)
        params = qwen3.init_params(config, generator, dtype=dtype, device=device)
    elif draw == "threefry":
        params = qwen3.init_params_threefry(config, seed, dtype=dtype, device=device)
    else:
        raise ValueError(f"unknown draw {draw!r}: 'torch' or 'threefry'")
    params = shard_params(params, mesh, config) if mesh is not None else trainable(params)
    return params, optimizer(params)


def opt_state_from_optax(
    optimizer: AdamW, params: dict, mu: dict, nu: dict, count: int
) -> torch.optim.AdamW:
    """An optimizer state over ``params`` carrying a JAX ``optax.adamw``
    state mid-run: its first and second moments ``mu`` and ``nu`` (params
    trees of numpy arrays, the layout of ``hf_loader.params_from_jax``'s
    input) and its step ``count``."""
    opt_state = optimizer(params)
    for leaf, m, v in zip(param_leaves(params), param_leaves(mu), param_leaves(nu)):
        def tensor(x):
            return torch.tensor(np.array(x), dtype=leaf.dtype, device=leaf.device)

        opt_state.state[leaf] = {
            "step": torch.tensor(float(count)),
            "exp_avg": tensor(m),
            "exp_avg_sq": tensor(v),
        }
    return opt_state

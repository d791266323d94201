"""The port's reranker training against the JAX package's, step by step,
on the CPU, from one init.

At the committed arguments of scripts/train_reranker_e2e.py (the 20k
chain: 20,000 declarations, 1,200 concepts, 256 x 4, max length 96, batch
64, name variants on, the 4000-step warmup-cosine schedule) this script:

1. checks that the port's ``CrossEncoderDataLoader`` yields JAX's first
   ``--check-batches`` batches, value for value;
2. runs JAX's ``make_ce_train_step`` (one-device CPU mesh) and the port's
   ``make_ce_train_step`` side by side on those batches from JAX's init
   (``init_train_state`` at ``--seed``, carried across by
   ``hf_loader.params_from_jax``), and beside them JAX's step again from
   the same init with layer 0's query projection moved by one unit in the
   last place, in one entry and in every entry (the twins);
3. logs every step's losses and, for the port and each twin, the largest
   and the relative (L2) parameter difference from JAX's run and the first step whose loss
   leaves the per-step tolerance of
   tests/test_torch_train.py::test_train_steps_match_jax: |loss - JAX's|
   <= 2 sum |g| |p - p_jax| + 1e-5 |loss_jax|, with p the params before the
   step and g the gradient of JAX's loss at JAX's params (one more
   forward and backward a step), and by the other measures of
   ``first_steps``.

``--bisect`` repeats step 2-3 at smaller inputs (name variants off, then
depth, width, max length and corpus size cut one at a time) for
``--bisect-steps`` steps each. Everything goes to one JSON file:

    JAX_PLATFORMS=cpu python scripts/compare_torch_reranker_trajectory.py \\
        --run-steps 400 --bisect --out runs/jax_f32_cpu/reranker_trajectory.json
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

LOSS_RTOL = 1e-5  # tests/test_torch_train.py


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path,
                        default=REPO / "runs" / "jax_f32_cpu" / "reranker_trajectory.json")
    parser.add_argument("--n-decls", type=int, default=20_000)
    parser.add_argument("--n-concepts", type=int, default=1200)
    parser.add_argument("--n-eval", type=int, default=512)
    parser.add_argument("--hidden-size", type=int, default=256)
    parser.add_argument("--num-layers", type=int, default=4)
    parser.add_argument("--max-length", type=int, default=96)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--learning-rate", type=float, default=3e-4)
    parser.add_argument("--steps", type=int, default=4000, help="the schedule's length")
    parser.add_argument("--run-steps", type=int, default=400, help="steps driven")
    parser.add_argument("--check-batches", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-name-variants", action="store_true")
    parser.add_argument("--bisect", action="store_true")
    parser.add_argument("--bisect-steps", type=int, default=150)
    parser.add_argument("--threads", type=int, default=8)
    return parser.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Task:
    """The corpus, the reranker tokenizer (both packages' readers of one
    file) and the labeled examples of the JAX script at these arguments."""

    def __init__(self, args, work: Path, *, name_variants: bool):
        from lean_explore_tpu.models.tokenizer import load_tokenizer as jax_load
        from lean_explore_tpu.train.cross_encoder import format_pair
        from lean_explore_tpu.train.synthetic import (
            build_wordlevel_tokenizer,
            make_corpus,
            make_reranker_examples,
        )
        from lean_explore_tpu_torch.models.tokenizer import load_tokenizer
        from lean_explore_tpu_torch.train import synthetic as TS

        corpus = make_corpus(n_decls=args.n_decls, n_concepts=args.n_concepts,
                             n_eval=args.n_eval, seed=args.seed, body_sentences=1)
        tok_dir = build_wordlevel_tokenizer(
            corpus.texts(), work / "tokenizer", extra_texts=(format_pair("q", "d"), "true false")
        )
        self.hf = jax_load(tok_dir)
        self.tokenizer = load_tokenizer(tok_dir)
        self.examples = make_reranker_examples(
            corpus, np.random.default_rng(args.seed + 1), name_variants=name_variants
        )
        port_corpus = TS.make_corpus(n_decls=args.n_decls, n_concepts=args.n_concepts,
                                     n_eval=args.n_eval, seed=args.seed, body_sentences=1)
        port_examples = TS.make_reranker_examples(
            port_corpus, np.random.default_rng(args.seed + 1), name_variants=name_variants
        )
        if port_examples != self.examples:
            raise SystemExit("the port's reranker examples differ from JAX's")
        self.token_true = int(self.hf.convert_tokens_to_ids("true"))
        self.token_false = int(self.hf.convert_tokens_to_ids("false"))
        self.vocab_size = (self.hf.vocab_size + 7) // 8 * 8


def jax_batches(task: Task, args, n: int):
    """JAX's loader as numpy arrays, after checking that the port's loader
    gives the same values for its first ``n`` batches."""
    from lean_explore_tpu.train.cross_encoder import CrossEncoderDataLoader as JaxLoader
    from lean_explore_tpu_torch.train.cross_encoder import CrossEncoderDataLoader

    kw = dict(batch_size=args.batch_size, max_length=args.max_length, seed=args.seed)
    want = JaxLoader(task.hf, task.examples, **kw)
    got = iter(CrossEncoderDataLoader(task.tokenizer, task.examples, **kw))
    checked = []
    for i, batch in zip(range(n), want):
        arrays = [np.asarray(x) for x in batch]
        for g, x in zip(next(got), arrays):
            if not np.array_equal(g.numpy(), x):
                raise SystemExit(f"batch {i}: the port's loader differs from JAX's")
        checked.append(arrays)
    yield from checked
    for batch in want:
        yield [np.asarray(x) for x in batch]


def trajectory(args, task: Task, batches: list, run_steps: int) -> dict:
    """JAX, the port and JAX's twins for ``run_steps`` steps on ``batches``
    (cycled), with the per-step record described in the module docstring."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from lean_explore_tpu.models.qwen3 import Qwen3Config
    from lean_explore_tpu.parallel import TRAIN_AXES, make_mesh
    from lean_explore_tpu.train import contrastive as JC
    from lean_explore_tpu.train import cross_encoder as JX
    from lean_explore_tpu_torch.models import hf_loader
    from lean_explore_tpu_torch.train import contrastive as TC
    from lean_explore_tpu_torch.train import cross_encoder as TX
    from lean_explore_tpu_torch.train import e2e

    h = args.hidden_size
    config = Qwen3Config(vocab_size=task.vocab_size, hidden_size=h,
                         num_hidden_layers=args.num_layers, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=h // 4, intermediate_size=2 * h)
    kw = dict(token_true=task.token_true, token_false=task.token_false)
    mesh = make_mesh((1, 1), axis_names=TRAIN_AXES, devices=jax.devices()[:1])
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=args.learning_rate,
        warmup_steps=min(200, args.steps // 10 + 1), decay_steps=args.steps,
        end_value=args.learning_rate * 0.05,
    )
    optimizer = JC.make_optimizer(learning_rate=schedule)
    jparams, jstate = JC.init_train_state(config, mesh, optimizer, seed=args.seed)
    init = jax.tree.map(np.asarray, jparams)

    # The twins, JAX's run again from the init with layer 0's query
    # projection moved one ulp up: in one entry, and in every entry.
    twins = {}
    for name, index in (("twin_entry", (0, 0, 0)), ("twin_leaf", (0,))):
        twin_init = jax.tree.map(np.copy, init)
        leaf = twin_init["layers"]["q_proj"]  # [layer, in, out]
        leaf[index] = np.nextafter(leaf[index], np.float32(np.inf))
        tparams = JC.shard_params(jax.tree.map(jnp.asarray, twin_init), mesh, config)
        twins[name] = [tparams, JC.commit_to_mesh(jax.jit(optimizer.init)(tparams), mesh)]

    jstep = JX.make_ce_train_step(config, mesh, optimizer, **kw)
    jgrad = jax.jit(jax.grad(lambda p, b: JX.cross_encoder_loss(p, config, b, **kw)[0]))

    pconfig = e2e.model_config(task.vocab_size, h, args.num_layers)
    pparams = TC.trainable(hf_loader.params_from_jax(init, device="cpu"))
    popt = TC.make_optimizer(learning_rate=e2e.lr_schedule(args.learning_rate, args.steps))(pparams)
    pstep = TX.make_ce_train_step(pconfig, **kw)

    def leaves(tree):
        return TC.param_leaves(jax.tree.map(np.asarray, tree))

    names = ("port", *twins)
    rows, first_out = [], dict.fromkeys(names)
    norm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in leaves(jparams)))
    started = time.perf_counter()
    for t, arrays in zip(range(run_steps), batches):
        jb = JX.CrossEncoderBatch(*(jnp.asarray(x) for x in arrays))
        pb = TX.CrossEncoderBatch(*(torch.from_numpy(x) for x in arrays))
        ref = leaves(jparams)
        grads = leaves(jgrad(jparams, jb))
        before = {"port": [p.detach().numpy().copy() for p in TC.param_leaves(pparams)]}
        before.update({name: leaves(state[0]) for name, state in twins.items()})
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        pparams, popt, pm = pstep(pparams, popt, pb)
        metrics = {"port": pm}
        for name, state in twins.items():
            state[0], state[1], metrics[name] = jstep(state[0], state[1], jb)
        row = {"step": t + 1, "jax": float(jm["loss"])}
        for name in names:
            loss = float(metrics[name]["loss"])
            diffs = [b - r for b, r in zip(before[name], ref)]
            first_order = sum(float(np.abs(g * d).sum()) for g, d in zip(grads, diffs))
            tol = 2 * first_order + LOSS_RTOL * abs(row["jax"])
            row[name] = loss
            row[f"{name}_max_dp"] = max(float(np.abs(d).max()) for d in diffs)
            row[f"{name}_rel_dp"] = np.sqrt(
                sum(float((d.astype(np.float64) ** 2).sum()) for d in diffs)) / norm
            row[f"{name}_tol"] = tol
            if first_out[name] is None and abs(loss - row["jax"]) > tol:
                first_out[name] = t + 1
        rows.append(row)
        if (t + 1) % 10 == 0 or t == 0:
            log(f"step {t + 1}: jax {row['jax']:.6f} " + " ".join(
                f"{n} {row[n]:.6f} ({row[f'{n}_rel_dp']:.1e})" for n in names)
                + f"; first out {first_out} ({time.perf_counter() - started:.0f} s)")
    return {"first_step_out_of_tolerance": first_out,
            "first_steps": first_steps(rows, names, e2e.lr_schedule(args.learning_rate, args.steps)),
            "steps": rows}


def adam_update_bounds(steps: int, b1=0.9, b2=0.999) -> list[float]:
    """U_t for t = 1..steps, the largest |update| of Adam at step t
    (tests/test_torch_train.py's module docstring)."""
    bounds = []
    for t in range(1, steps + 1):
        ratio = sum(((1 - b1) * b1 ** (t - i) / (1 - b1**t)) ** 2
                    / ((1 - b2) * b2 ** (t - i) / (1 - b2**t)) for i in range(1, t + 1))
        bounds.append(ratio**0.5)
    return bounds


def first_steps(rows: list[dict], names, schedule) -> dict:
    """For each run beside JAX's, the first step at which it leaves JAX's
    by each measure: the per-step loss tolerance above; its largest
    parameter difference beyond 2 sum_t lr_t U_t, the a-priori bound of
    tests/test_torch_e2e_training.py's trajectory test (the init's
    difference added); the loss gap beyond 1e-3 and 1e-2; the relative
    parameter difference beyond 1e-4 and 1e-3. None: not within the run."""
    bounds = adam_update_bounds(len(rows))
    out = {name: dict.fromkeys(("step_loss_tolerance", "apriori_param_bound", "loss_gap_1e-3",
                                "loss_gap_1e-2", "rel_dp_1e-4", "rel_dp_1e-3"))
           for name in names}
    moved = 0.0
    for row, u in zip(rows, bounds):
        for name in names:
            # The init's difference: the parameters before step 1.
            init_dp = rows[0][f"{name}_max_dp"]
            tests = {
                "step_loss_tolerance": abs(row[name] - row["jax"]) > row[f"{name}_tol"],
                "apriori_param_bound": row[f"{name}_max_dp"] > 2 * moved + init_dp,
                "loss_gap_1e-3": abs(row[name] - row["jax"]) > 1e-3,
                "loss_gap_1e-2": abs(row[name] - row["jax"]) > 1e-2,
                "rel_dp_1e-4": row[f"{name}_rel_dp"] > 1e-4,
                "rel_dp_1e-3": row[f"{name}_rel_dp"] > 1e-3,
            }
            for key, left in tests.items():
                if left and out[name][key] is None:
                    out[name][key] = row["step"]
        moved += float(schedule(row["step"] - 1)) * u
    return out


def run(args, work: Path, *, name_variants: bool, run_steps: int, check: int) -> dict:
    task = Task(args, work, name_variants=name_variants)
    batches = jax_batches(task, args, check)
    result = trajectory(args, task, batches, run_steps)
    log(f"loader: the port's first {check} batches equal JAX's "
        f"({len(task.examples)} examples)")
    result["loader_batches_equal"] = check
    result["n_examples"] = len(task.examples)
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    import tempfile

    arguments = {k: (str(v) if isinstance(v, Path) else v) for k, v in vars(args).items()}
    report = {"arguments": arguments, "jax": jax.__version__, "torch": torch.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        report["committed"] = run(args, Path(tmp) / "main", name_variants=not args.no_name_variants,
                                  run_steps=args.run_steps, check=args.check_batches)
        if args.bisect:
            cuts = [
                ("no_name_variants", {}),
                ("num_layers_2", {"num_layers": 2}),
                ("hidden_64", {"hidden_size": 64}),
                ("max_length_48", {"max_length": 48}),
                ("n_decls_2000", {"n_decls": 2000, "n_concepts": 120, "n_eval": 64}),
            ]
            report["bisect"] = {}
            for label, cut in cuts:
                sub = argparse.Namespace(**{**vars(args), **cut})
                log(f"bisect: {label}")
                result = run(sub, Path(tmp) / label, name_variants=label != "no_name_variants"
                             and not args.no_name_variants,
                             run_steps=args.bisect_steps, check=min(args.check_batches, 20))
                report["bisect"][label] = {"cut": cut, **result}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1) + "\n")
    log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())

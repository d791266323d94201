"""The comparison that decides ``correct``.

Each number below is a worst case over the requests (or documents) that
the run sampled from its seed, taken from what the timed path produced and
held to the float32 reference of ``model`` and ``text``:

- ``embed_err``: 1 - cosine between a served embedding (a query's, or in
  the index build a document's) and the reference's;
- ``dense_gap``: how far below the reference's k-th best bin maximum (the
  configuration's bin-max retrieval: row r in bin r % dense_bins) a served
  dense candidate scores, by the reference's exact inner product with the
  served query vector;
- ``rerank_err``: the largest gap between a served P("true") and the
  reference's, as log-odds (the cascade's full-length second stage);
- ``stage1_err`` (cascade): the same for the truncated first stage;
- ``keep_gap`` (cascade): how far below the reference's keep-th best
  first-stage log-odds a document kept for the second stage lies;
- ``rank_gap``: how far below the best remaining candidate, by the
  reference's final fused score, each returned id lies, in order;
- ``pool_miss``: a count that has to be 0: sampled requests whose
  candidate pool, the documents handed to the reranker, is not the one the
  plain reference of the lexical stage, the fusion with the served dense
  candidates and the dependency boost (``pool``) picks, as a set of
  ``rerank_top`` documents;
- ``mismatch``: a count that has to be 0: a served candidate document whose
  text is not its declaration's, a returned id outside the candidates, a
  short answer, a duplicate dense id, or (index build) a stored embedding
  that differs from the one served.

The control is the same reference computed with fp8 products
(``model.matmul``): ``control_outputs`` makes its outputs from the same
inputs, and ``judge`` holds them to the float32 reference exactly as it
holds the program's.
"""

import json
import sys
from dataclasses import dataclass

import numpy as np
import torch

from reference import model, pool, text


@dataclass
class SearchSample:
    """One served request, as the timed path produced it."""

    query: str
    query_vec: np.ndarray  # [D] f32
    dense_ids: np.ndarray  # [k] declaration ids (row + 1)
    dense_scores: np.ndarray  # [k] their served scores, in the same order
    pool: list[str]  # the documents handed to the reranker
    scores: list[float]  # the reranker's final P("true") per pool document
    returned: list[int]  # the ids answered, in order
    stage1: list[float] | None = None  # cascade: first-stage P("true") per pool document
    kept: list[str] | None = None  # cascade: the documents rescored
    stage2: list[float] | None = None  # cascade: their full-length P("true")
    broken: str | None = None  # what was missing, when a layer gave too few outputs


def _logodds(p) -> np.ndarray:
    p = np.clip(np.asarray(p, dtype=np.float64), 1e-12, 1 - 1e-12)
    return np.log(p) - np.log1p(-p)


class Judge:
    """The reference state of one run: configuration, corpus, vocabulary,
    regenerated weights and corpus rows on ``device``."""

    def __init__(self, cfg, corpus, vocab, params_embed, params_rerank, rows_bf16, device):
        self.cfg, self.corpus, self.device = cfg, corpus, device
        self.model_cfg = cfg["model"]
        self.serve = cfg["serving"]
        self.tok = text.Tokenizer(vocab)
        self.pe, self.pr = params_embed, params_rerank
        self.rows = rows_bf16
        self.row_of = {n: i for i, n in enumerate(corpus.names)}
        self.t_true, self.t_false = vocab["true"], vocab["false"]

    # -------------------------------------------------------------- model side
    def query_rows(self, queries):
        return text.query_rows(self.tok, self.serve["query_prompt"], queries,
                               self.serve["embed_max_length"])

    def embed_queries(self, queries, precision="f32") -> torch.Tensor:
        return model.embed(self.pe, self.model_cfg, self.query_rows(queries), self.device, precision)

    def embed_documents(self, docs, precision="f32") -> torch.Tensor:
        rows = text.document_rows(self.tok, docs, self.serve["embed_max_length"])
        return model.embed(self.pe, self.model_cfg, rows, self.device, precision)

    def pair_logits(self, query, docs, suffix_cap=None, precision="f32") -> np.ndarray:
        rows, _ = text.pair_rows(self.tok, self.serve["instruction"], query, docs,
                                 self.serve["rerank_max_length"], suffix_cap)
        return model.yes_no_logit(self.pr, self.model_cfg, rows, self.t_true, self.t_false,
                                  self.device, precision).double().cpu().numpy()

    def dense_scores(self, vecs: torch.Tensor, precision="f32") -> torch.Tensor:
        q = vecs.float()
        q = q / q.norm(dim=-1, keepdim=True)
        return model.matmul(q, self.rows.float().T, precision)

    def bin_threshold(self, scores: torch.Tensor, k: int) -> torch.Tensor:
        bins = self.serve["dense_bins"]
        n = scores.shape[1]
        pad = -n % bins
        padded = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
        best = padded.view(scores.shape[0], -1, bins).amax(dim=1)
        return best.topk(k, dim=1).values[:, -1]

    # ------------------------------------------------------------- fusion side
    def fused(self, query, pool, rerank_p) -> np.ndarray:
        rows = [self.row_of[d.split(": ", 1)[0]] for d in pool]
        c = self.corpus
        deps = [text_deps(c.dependencies[r]) for r in rows]
        return text.fused_scores(query, [c.names[r] for r in rows],
                                 [c.informalizations[r] for r in rows], deps, rerank_p)

    def cascade_signal(self, pool, kept, full_logit, stage1_logit) -> np.ndarray:
        """The cascade's rerank signal: kept documents their full-length
        P("true"); the rest in first-stage order just under the worst kept."""
        index = {d: i for i, d in enumerate(pool)}
        kept_idx = [index[d] for d in kept]
        out = np.zeros(len(pool))
        p_kept = 1 / (1 + np.exp(-np.asarray(full_logit)))
        out[kept_idx] = p_kept
        floor = p_kept.min() if len(p_kept) else 0.0
        rest = [i for i in range(len(pool)) if i not in set(kept_idx)]
        rest.sort(key=lambda i: -stage1_logit[i])
        for j, i in enumerate(rest):
            out[i] = floor - 1e-4 * (j + 1)
        return out


def text_deps(deps_json):
    return json.loads(deps_json) if deps_json else []


def _rank_gap(final: np.ndarray, returned_idx: list[int]) -> float:
    remaining = set(range(len(final)))
    gap = 0.0
    for i in returned_idx:
        best = max(final[j] for j in remaining)
        gap = max(gap, best - final[i])
        remaining.discard(i)
    return gap


def pool_misses(j: Judge, samples: list[SearchSample], rerank_top: int) -> int:
    """Requests whose served pool is not the reference's (``pool``)."""
    c = j.corpus
    ref = pool.PoolReference(c.names, lambda row: text_deps(c.dependencies[row]), [s.query for s in samples])
    misses = 0
    for s in samples:
        want = ref.pool(s.query, s.dense_ids, s.dense_scores, j.serve["bm25_k"], rerank_top)
        got = [j.row_of.get(d.split(": ", 1)[0], -1) + 1 for d in s.pool]
        if len(got) != len(set(got)) or set(got) != set(want):
            misses += 1
            print(f"pool_miss: {s.query!r}: {len(set(got) - set(want))} of {len(got)} served documents "
                  f"not among the reference's {len(want)}", file=sys.stderr)
    return misses


def judge_search(j: Judge, samples: list[SearchSample], limit: int, rerank_top: int, cascade) -> dict:
    """The numbers of a search cell, worst over ``samples``."""
    out = {"embed_err": 0.0, "dense_gap": 0.0, "rerank_err": 0.0, "rank_gap": 0.0, "pool_miss": 0,
           "mismatch": 0}
    if cascade:
        out.update(stage1_err=0.0, keep_gap=0.0)
    out["mismatch"] = sum(1 for s in samples if s.broken)
    samples = [s for s in samples if not s.broken]
    if not samples:  # nothing answered in the window: nothing to hold up
        out["mismatch"] += 1
        return out
    queries = [s.query for s in samples]
    ref_vecs = j.embed_queries(queries)
    served = torch.tensor(np.stack([s.query_vec for s in samples]), device=j.device)
    cos = torch.nn.functional.cosine_similarity(served.float(), ref_vecs, dim=-1)
    out["embed_err"] = float((1 - cos).max())

    k = j.serve["dense_k"]
    scores = j.dense_scores(served)
    threshold = j.bin_threshold(scores, k)
    for i, s in enumerate(samples):
        rows = torch.as_tensor(np.asarray(s.dense_ids) - 1, device=j.device)
        if len(set(s.dense_ids.tolist())) != k or int(rows.min()) < 0 or int(rows.max()) >= scores.shape[1]:
            out["mismatch"] += 1
            continue
        out["dense_gap"] = max(out["dense_gap"], float((threshold[i] - scores[i, rows]).clamp_min(0).max()))
    out["pool_miss"] = pool_misses(j, samples, rerank_top)

    for s in samples:
        if any(d.split(": ", 1)[0] not in j.row_of or d != j.corpus.document(j.row_of[d.split(": ", 1)[0]])
               for d in s.pool):
            out["mismatch"] += 1
            continue
        if cascade and (s.stage1 is None or s.kept is None):  # no cascade ran
            out["mismatch"] += 1
            continue
        if cascade:
            cap, keep = cascade
            d1 = j.pair_logits(s.query, s.pool, suffix_cap=cap)
            out["stage1_err"] = max(out["stage1_err"], float(np.abs(_logodds(s.stage1) - d1).max()))
            index = {d: i for i, d in enumerate(s.pool)}
            kept_idx = [index[d] for d in s.kept if d in index]
            if len(kept_idx) != min(keep, len(s.pool)):
                out["mismatch"] += 1
                continue
            kth = np.sort(d1)[::-1][len(kept_idx) - 1]
            out["keep_gap"] = max(out["keep_gap"], float(np.max(kth - d1[kept_idx])))
            d2 = j.pair_logits(s.query, s.kept)
            out["rerank_err"] = max(out["rerank_err"], float(np.abs(_logodds(s.stage2) - d2).max()))
            signal = j.cascade_signal(s.pool, s.kept, d2, d1)
        else:
            d = j.pair_logits(s.query, s.pool)
            out["rerank_err"] = max(out["rerank_err"], float(np.abs(_logodds(s.scores) - d).max()))
            signal = 1 / (1 + np.exp(-d))
        final = j.fused(s.query, s.pool, signal)
        pool_ids = [j.row_of[d.split(": ", 1)[0]] + 1 for d in s.pool]
        where = {cid: i for i, cid in enumerate(pool_ids)}
        if len(s.returned) != min(limit, len(s.pool)) or any(r not in where for r in s.returned) \
                or len(set(s.returned)) != len(s.returned):
            out["mismatch"] += 1
            continue
        out["rank_gap"] = max(out["rank_gap"], _rank_gap(final, [where[r] for r in s.returned]))
    return out


def control_samples(j: Judge, samples: list[SearchSample], limit: int, cascade) -> list[SearchSample]:
    """The fp8 reference's outputs on the same requests and candidate pools."""
    vecs = j.embed_queries([s.query for s in samples], precision="fp8")
    k = j.serve["dense_k"]
    scores = j.dense_scores(vecs, precision="fp8")
    bins = j.serve["dense_bins"]
    n = scores.shape[1]
    padded = torch.nn.functional.pad(scores, (0, -n % bins), value=float("-inf"))
    best, arg = padded.view(len(samples), -1, bins).max(dim=1)
    top_scores, top = best.topk(k, dim=1)
    rows = (arg.gather(1, top) * bins + top).cpu().numpy()
    out = []
    for i, s in enumerate(samples):
        if cascade:
            cap, keep = cascade
            d1 = j.pair_logits(s.query, s.pool, suffix_cap=cap, precision="fp8")
            order = np.argsort(-d1, kind="stable")[:keep]
            kept = [s.pool[t] for t in order]
            d2 = j.pair_logits(s.query, kept, precision="fp8")
            signal = j.cascade_signal(s.pool, kept, d2, d1)
            p1, p2 = 1 / (1 + np.exp(-d1)), 1 / (1 + np.exp(-d2))
        else:
            d = j.pair_logits(s.query, s.pool, precision="fp8")
            signal, p1, kept, p2 = 1 / (1 + np.exp(-d)), None, None, None
        final = j.fused(s.query, s.pool, signal)
        ranked = np.argsort(-final, kind="stable")[:limit]
        pool_ids = [j.row_of[d.split(": ", 1)[0]] + 1 for d in s.pool]
        out.append(SearchSample(
            query=s.query, query_vec=vecs[i].cpu().numpy(), dense_ids=rows[i] + 1,
            dense_scores=top_scores[i].float().cpu().numpy(),
            pool=s.pool, scores=list(signal), returned=[pool_ids[t] for t in ranked],
            stage1=None if p1 is None else list(p1), kept=kept,
            stage2=None if p2 is None else list(p2),
        ))
    return out


def judge_documents(j: Judge, docs: list[str], served: np.ndarray, written_mismatch: int,
                    precision_of_served: str | None = None) -> dict:
    """The numbers of the index build: served document embeddings against
    the reference's, and the stored copies against the served."""
    ref = j.embed_documents(docs)
    got = torch.tensor(served, device=j.device) if precision_of_served is None \
        else j.embed_documents(docs, precision=precision_of_served)
    cos = torch.nn.functional.cosine_similarity(got.float(), ref, dim=-1)
    return {"embed_err": float((1 - cos).max()), "mismatch": int(written_mismatch)}

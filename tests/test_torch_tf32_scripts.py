"""The float32 retrieval kernels' measurement scripts against the sources
they measure, on the CPU: every variant of ``scripts/time_tf32_variants.py``
still matches ``lean_explore_tpu_torch/csrc`` (a variant whose string is
gone would stop the script on the card), and the tf32 wgmma count of
``scripts/measure_mma_tf32_rate.py`` covers each corpus row once per block
of 128 queries and k8 step, three times (3xTF32)."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import measure_mma_tf32_rate as rate  # noqa: E402
import time_tf32_variants as variants  # noqa: E402


@pytest.mark.parametrize("name", sorted(variants.VARIANTS))
def test_variant_matches_the_sources(tmp_path, name):
    _, kernels, edits = variants.VARIANTS[name]
    tree = variants.variant_tree(tmp_path, edits)
    for file, old, new, _ in edits:
        text = (tree / file).read_text()
        assert old not in text or old in new
        assert new in text
    assert kernels and set(kernels) <= {variants.K1, variants.K3}


def test_variant_with_a_missing_string_stops(tmp_path):
    with pytest.raises(ValueError, match="no longer matches"):
        variants.variant_tree(tmp_path, [("bin_topk.cu", "no such line", "", 1)])


@pytest.mark.parametrize(
    "n,dim,batch,bins",
    [(300_032, 1024, 128, 4096), (64 * 9, 32, 200, 64), (192 * 10 + 64, 96, 1, 192)],
)
def test_tf32_retrieval_counts(n, dim, batch, bins):
    counts = rate.tf32_retrieval_counts(n, dim, batch, bins)
    per_group = -(-batch // 128) * (dim // 8) * 3
    assert counts["windowed_scores_f32"] == 2 * -(-n // 128) * per_group
    # K1: two warpgroups for every (128-bin slice, super-tile) inside the corpus
    pairs = sum(1 for p in range(-(-n // bins)) for s0 in range(0, bins, 128) if p * bins + s0 < n)
    assert counts["bin_topk_f32"] == 2 * pairs * per_group
    if n == 300_032:
        assert counts["bin_topk_f32"] == n // 64 * 128 * 3 == 1_800_192

"""The bf16 retrieval kernels' variants script against the sources it
measures, on the CPU: every variant of ``scripts/time_bf16_variants.py``
still matches ``lean_explore_tpu_torch/csrc`` (a variant whose string is
gone would stop the script on the card), each same-function variant fits
the shared memory of one block, and the ablations are the ones the script
names."""

import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import time_bf16_variants as variants  # noqa: E402

# A block's dynamic shared memory on the H100 (cudaFuncSetAttribute's limit).
SMEM_LIMIT = 232448
STAGE = 32768  # a bf16 ring stage: 128 corpus rows and 128 queries, 128 bytes deep
BARRIERS = 16  # a stage's full and empty mbarriers


def _constant(text: str, name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, name
    return int(found[0])


@pytest.mark.parametrize("name", sorted(variants.VARIANTS))
def test_variant_matches_the_sources(tmp_path, name):
    _, kernels, edits = variants.VARIANTS[name]
    tree = variants.common.variant_tree(tmp_path, edits)
    for file, old, new, _ in edits:
        text = (tree / file).read_text()
        assert old not in text or old in new
        assert new in text
    assert kernels and set(kernels) <= {variants.K1, variants.K3}


@pytest.mark.parametrize("name", ["base"] + sorted(variants.VARIANTS))
def test_variant_fits_one_block(tmp_path, name):
    """The bf16 kernels' shared memory as each build sizes it: the ring,
    its barriers and the 1024-byte alignment, then K1's carry (64 KB, or 512
    bytes with the carry in registers) or K3's staged tiles (64 rows of 136
    f32 a warpgroup)."""
    edits = [] if name == "base" else variants.VARIANTS[name][2]
    tree = variants.common.variant_tree(tmp_path, edits)
    carry = (tree / "bin_topk.cu").read_text()
    window = (tree / "windowed_scores.cu").read_text()
    stride = _constant(carry, "GROUP_THREADS")
    k1 = _constant(carry, "BF16_CARRY_STAGES") * (STAGE + BARRIERS) + 2 * 64 * stride * 4 + 1024
    k3 = _constant(window, "BF16_WINDOW_STAGES") * (STAGE + BARRIERS) + 2 * 64 * 136 * 4 + 1024
    assert k1 <= SMEM_LIMIT and k3 <= SMEM_LIMIT


def test_ablations_are_named():
    ablations = {n for n, (same, _, _) in variants.VARIANTS.items() if not same}
    assert ablations == {"no_query_copies", "no_products", "no_fold", "no_store"}

"""The int8 retrieval kernel's variants script against the sources it
measures, on the CPU: every variant of ``scripts/time_int8_variants.py``
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

import time_int8_variants as variants  # noqa: E402

# A block's dynamic shared memory on the H100 (cudaFuncSetAttribute's limit).
SMEM_LIMIT = 232448
STAGE = 32768  # an int8 ring stage: 128 corpus rows and 128 queries, 128 bytes deep
BARRIERS = 16  # a stage's full and empty mbarriers
QUERY_SCALES = 128 * 4  # the block's query scales, after the carry


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
    assert kernels == (variants.K2,)


@pytest.mark.parametrize("name", ["base"] + sorted(variants.VARIANTS))
def test_variant_fits_one_block(tmp_path, name):
    """K2's shared memory as each build sizes it: the ring, its barriers
    and the 1024-byte alignment, then the carry (64 KB) and the query
    scales."""
    edits = [] if name == "base" else variants.VARIANTS[name][2]
    tree = variants.common.variant_tree(tmp_path, edits)
    stages = _constant((tree / "bin_topk_int8.cu").read_text(), "INT8_CARRY_STAGES")
    stride = _constant((tree / "ring_carry.cuh").read_text(), "GROUP_THREADS")
    smem = stages * (STAGE + BARRIERS) + 2 * 64 * stride * 4 + QUERY_SCALES + 1024
    assert smem <= SMEM_LIMIT


def test_ablations_are_named():
    ablations = {n for n, (same, _, _) in variants.VARIANTS.items() if not same}
    assert ablations == {"no_query_copies", "no_products", "no_fold"}
    assert {n for n, (same, _, _) in variants.VARIANTS.items() if same} == {
        "carry_3_stages", "carry_5_stages", "deferred_wait", "deferred_wait_5_stages"}


def test_int8_kernel_takes_the_shared_ring_carry():
    """K2 is the shared carry template over the int8 stage, and the script
    builds and configures its one source."""
    source = (REPO / "lean_explore_tpu_torch" / "csrc" / "bin_topk_int8.cu").read_text()
    assert "launch_ring_carry<tiles::Int8Stage>" in source
    assert '#include "ring_carry.cuh"' in source

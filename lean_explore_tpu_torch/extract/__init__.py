"""Index-build stages of the extraction pipeline on one device: embed ->
index (lean_explore_tpu/extract). The host stages before them (doc-gen4,
parse, informalize) need a Lean toolchain or the network and are not
ported (ROADMAP A10)."""

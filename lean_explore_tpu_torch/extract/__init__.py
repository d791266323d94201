"""The extraction pipeline (lean_explore_tpu/extract): doc-gen4 -> parse ->
informalize -> embed -> index, the embed stage on one device."""

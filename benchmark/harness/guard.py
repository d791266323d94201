"""The check that no JAX, nor the JAX package the port comes from, is loaded
in the process that prints a result. Names are compared whole, by the part
before the first dot: ``lean_explore_tpu_torch`` is the port and passes."""

FORBIDDEN = ("jax", "jaxlib", "flax", "lean_explore_tpu")


def forbidden_modules(names) -> list[str]:
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})

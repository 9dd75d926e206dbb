"""Atomic, resumable checkpoints in the JAX package's layout (``manager``),
with the manifest's msgpack codec (``_msgpack``)."""

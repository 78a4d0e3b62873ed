"""Parallelism of the port: named process meshes (:mod:`.mesh`), the
collectives over them (:mod:`.collectives`) and the LM training step
over dp x sp (:mod:`.spmd`); tensor, pipeline and expert parallelism are
not ported yet (ROADMAP A10)."""

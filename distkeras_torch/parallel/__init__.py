"""Parallelism of the port: named process meshes (:mod:`.mesh`), the
collectives over them (:mod:`.collectives`: permutes, all-to-all, the
tp conjugates, the bucketed gradient reduce), the data-parallel step,
the LM training steps over dp x sp x tp and the MoE step over dp x ep
(:mod:`.spmd`), and the GPipe pipeline step over dp x pp x tp
(:mod:`.pipeline`)."""

from distkeras_torch.parallel.mesh import make_mesh, default_mesh  # noqa: F401

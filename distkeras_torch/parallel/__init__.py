"""Training steps of the port (:mod:`.spmd`): the single-device LM step
(meshes and sharding are not ported yet, ROADMAP A10)."""

"""Data parallelism: the mesh helpers (:mod:`.mesh`, the counterpart of
``afan/parallel/mesh.py``), the process launcher (:mod:`.launch`) and the
row-sharded step of a data x spatial mesh (:mod:`.spatial`)."""

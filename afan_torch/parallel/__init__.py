"""Data parallelism: the mesh helpers (:mod:`.mesh`, the counterpart of
``afan/parallel/mesh.py``) and the process launcher (:mod:`.launch`)."""

"""Device meshes for serving on more than one device: the data axis and
the model axis (``parallel/mesh.py``), and the model axis's collectives
(``parallel/collectives.py``)."""

"""The parallel layer: mesh axes in two forms (``axis.py``), the GPipe
schedule (``pipeline.py``) and the disaggregated pools
(``disaggregated.py``); the mesh itself is ``core/mesh.py``."""

"""LM launchers of the port (``repro.launch``): so far the batched greedy
``ServeLoop``; the mesh-sharded steps, ``serve.py`` and training wait for
the mesh item."""

"""Data parallelism over processes (counterpart of the JAX ``parallel/``):
``mesh.py`` joins the process group and holds every collective the
training path runs. Width sharding (the JAX ``parallel/spatial.py``) is
not ported."""

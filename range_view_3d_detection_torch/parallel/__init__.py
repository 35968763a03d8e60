"""Parallelism over processes (counterpart of the JAX ``parallel/``):
``mesh.py`` joins the process group and holds every collective of data
parallelism; ``spatial.py`` splits one image's width over the ranks
(exact width sharding, the JAX ``parallel/spatial.py``)."""

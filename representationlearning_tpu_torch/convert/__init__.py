"""Converters: the JAX package's variable trees to the port's state_dicts
(``from_jax``), and COCO annotations to VOC-style masks (``coco2voc``)."""

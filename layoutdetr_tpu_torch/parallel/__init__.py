"""Multi-GPU training: the rank grid and its collectives
(``distributed``) and the TP rules (``tensor_parallel``); the port's
counterpart of ``layoutdetr_tpu/parallel/mesh.py``."""

"""Row- and column-sharded embedding tables and retrieval on a mesh over
``torch.distributed``: the counterpart of ``tfrec_tpu/parallel/``
(``mesh``, ``embedding``, ``step``, ``topk``, ``eval``)."""

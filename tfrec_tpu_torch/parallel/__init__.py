"""Row-sharded embedding tables over ``torch.distributed``: the
counterpart of ``tfrec_tpu/parallel/`` (``mesh``, ``embedding``, ``step``)."""

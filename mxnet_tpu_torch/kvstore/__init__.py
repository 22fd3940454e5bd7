"""KVStore: the push/pull parameter interface (parity: ``mx.kv``).

A key -> NDArray store with ``init``/``push``/``pull``: the values pushed
for a key (one a context) are summed, optionally compressed first
(``2bit`` or ``int8`` with error feedback), then either handed to the
updater (``set_optimizer``) or assigned.  The modes:

==================  =====================================================
``local``,          one process: values are summed on the stored value's
``device``,         context and pulled back to each context
``nccl``
``dist_sync``,      one process a card over ``torch.distributed``
``dist_sync_device``  (``python -m mxnet_tpu_torch.launch``): the local
``dist``,           sum is all-reduced over the group (NCCL on a card,
``dist_tpu_sync``   gloo on the CPU); rank 0's value is broadcast at
                    ``init``; ``dist_tpu_sync`` is the reference's name
``dist_async``      raises, as the reference's
==================  =====================================================
"""
from .kvstore import (KVStore, KVStoreDist, KVStoreTPUSync, create,
                      init_distributed)

__all__ = ["KVStore", "KVStoreDist", "KVStoreTPUSync", "create",
           "init_distributed"]

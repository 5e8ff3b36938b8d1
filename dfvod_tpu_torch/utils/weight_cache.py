"""A module's tensors made from its weights (a FrozenBN fold, quantized
weights), kept for serving until a weight changes."""
from __future__ import annotations


class WeightCache:
    """One derived value, made again only when ``tag`` differs or a source
    tensor is replaced (``.to()``) or written in place (``load_state_dict``
    copies in place): the key is ``tag`` and each source's device, dtype,
    address and version counter. The sources are held, so their memory
    cannot be reused by another tensor at the same address. A write through
    ``.data`` goes unseen, as it does for autograd."""

    def __init__(self):
        self.key = self.value = self.sources = None

    def get(self, sources, make, tag=None):
        key = (tag, [(t.device, t.dtype, t.data_ptr(), t._version)
                     for t in sources])
        if key != self.key:
            self.value = make()
            self.key, self.sources = key, [t.detach() for t in sources]
        return self.value

"""``paddle.batch`` — the counterpart of ``paddle_tpu/minibatch.py``; it
carries a reader's pass-cache tags (``reader/pass_cache.py``)."""

from __future__ import annotations


def batch(reader, batch_size: int, drop_last: bool = False):
    """Group a sample reader into a minibatch reader."""

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    from paddle_tpu_torch.reader.pass_cache import copy_cache_tags

    # carry the @provider(cache=CACHE_PASS_IN_MEM) tags to the trainer
    return copy_cache_tags(reader, batch_reader)

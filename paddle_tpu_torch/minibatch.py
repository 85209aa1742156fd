"""``paddle.batch`` — the counterpart of ``paddle_tpu/minibatch.py`` (the
pass-cache tags it carries there are not ported yet)."""

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

    return batch_reader

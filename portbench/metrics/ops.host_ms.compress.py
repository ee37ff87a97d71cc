"""Host time per compress call in ``ops``, the codecs' glue: the
``rans.tables``, ``rans.stage``, ``rans.launch``, ``rans.compact`` and
``rans.assemble`` spans, less the waits and copies nested in them, ms."""

from portbench import spans


def read(ctx):
    return spans.exclusive_ms_per_call(
        ctx, "encode", ("rans.tables", "rans.stage", "rans.launch",
                       "rans.compact", "rans.assemble"),
        ("rans.wait", "rans.put", "rans.fetch"))

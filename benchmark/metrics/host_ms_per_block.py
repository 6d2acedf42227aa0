"""Host ms a block of the pipeline's dispatch and parse
(`Pipeline.timing`: step_dispatch + group_dispatch + host_parse, which
holds the frames' formatting into dicts)."""

UNIT = "ms"


def read(ctx):
    if not ctx.blocks:
        return None
    t = sum(ctx.timing.get(k, 0.0) for k in
            ("step_dispatch", "group_dispatch", "host_parse"))
    return t * 1e3 / ctx.blocks

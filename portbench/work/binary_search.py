"""The least work of one two-stage binary search call: the packed sign
codes (ceil(D/32) 32-bit words a row) and validity read once, the f32
queries read, the +-1 product of the prescan (2 * B * N * D operations);
then each distinct rescored row read once in its storage type with its
norm, and its product (2 * B * r * D); the [B, k] result written. The
distinct rows are the union of the batch's top-r sets, which the reference
counts on the checked calls (their mean)."""

from portbench.harness.bench import load_module

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def work(ctx):
    distinct = ctx.numbers.get("distinct_rows")
    if distinct is None:
        return None
    n, d, b, k = ctx.rows, ctx.dim, ctx.batch, ctx.k
    config = ctx.cell.config
    r = load_module("reference", "binary").rescore_rows(config, n, k)
    s = ITEMSIZE[config["db"]["device"]["storage_dtype"]]
    words = (d + 31) // 32
    nbytes = n * (words * 4 + 1) + b * d * 4 + distinct * (d * s + 4) + b * k * 12
    return float(nbytes), 2.0 * b * n * d + 2.0 * b * r * d

"""The least work of one exact flat search call: each stored row read once
in its storage type with its f32 norm and validity byte, the f32 queries
read, the [B, k] result (f32 score, int64 slot) written; 2 * B * N * D
operations of the product. N counts the stored documents, not the padded
capacity."""

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def work(ctx):
    n, d, b, k = ctx.rows, ctx.dim, ctx.batch, ctx.k
    s = ITEMSIZE[ctx.cell.config["db"]["device"]["storage_dtype"]]
    nbytes = n * (d * s + 4 + 1) + b * d * 4 + b * k * 12
    return float(nbytes), 2.0 * b * n * d

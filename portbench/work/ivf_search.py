"""The least work of one IVF search call, from the configuration and the
traffic alone: the f32 centroids and queries read, each probed list read
once (its rows in the storage type, each with its f32 weight), the [B, k]
result (f32 score, int64 slot) written; the centroid product and the
probed rows' products, 2 * B * D * (nlist + nprobe * N / nlist) operations.

It assumes uniform probing: lists of N / nlist rows, each query's nprobe
lists drawn apart from the other queries', so that a batch of B probes
E = nlist * (1 - (1 - nprobe / nlist) ** B) distinct lists."""

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def work(ctx):
    n, d, b, k = ctx.rows, ctx.dim, ctx.batch, ctx.k
    config = ctx.cell.config
    nlist, nprobe = int(config["db"]["index"]["nlist"]), int(config["db"]["index"]["nprobe"])
    s = ITEMSIZE[config["db"]["device"]["storage_dtype"]]
    probed = nlist * (1.0 - (1.0 - nprobe / nlist) ** b)
    nbytes = probed * (n / nlist) * (d * s + 4) + nlist * d * 4 + b * d * 4 + b * k * 12
    return float(nbytes), 2.0 * b * d * (nlist + nprobe * n / nlist)

"""On-card smoke test of the PyTorch + CUDA port (grape_vector_db_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU (Hopper) and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, started
together), checks each kernel against its plain PyTorch version, and drives
the port's paths through ``VectorDatabase`` on the card:

- flat (cosine, bf16, D=768) at 1,048,576 seeded Gaussian documents, against
  a numpy oracle; its large-corpus search runs B1/B2, in bf16 storage the
  persistent TMA + wgmma kernel of ``csrc/segmax_max.cu`` (held against
  their plain versions at B=128 and timed beside the nearest library
  composition; in f32 storage they run the ``csrc/segmax.cu`` template,
  checked on an exact integer case);
- the segment-max entry points at the same width (1,048,576 x 768 bf16,
  B=128): ``segmax_topk`` with both layouts (B9, B10), ``segmax4_topk(impl=
  "sup")`` (B7) and ``segmax2_topk(impl="selfold")`` (B8), at k = 10, k = 3
  and filtered, against the exact one-matmul oracle on the card, after each
  of B7-B10 is held against its plain version (in bf16 storage all four run
  the TMA + wgmma kernel of ``csrc/segmax_max.cu``, in f32 storage the
  ``csrc/segmax.cu`` template); B7 and B8 are timed in turns with B1 and B2
  and with their library compositions, at B = 128 and B = 256;
- the IVF family at the repository's 1M IVF configuration (bench.py:483-506:
  1,048,576 x 768 clustered rows, 16,384 Gaussian centres + 0.25 noise,
  nlist 4096, nprobe 16): ``ivf`` runs B3, ``ivf_int8`` B4 and ``ivf_int4``
  B5 (``csrc/ivf_probe.cu``; B4 and B5 are a grouping pass that sorts the
  probe cells by list, then a kernel that streams each list once for up to 8
  of its cells on the bf16 tensor cores: for B4 a persistent grid fed by TMA
  copies on mbarriers, for B5 one block a group) through ingest, search before and after
  ``optimize()``, filtered search on both planner routes, the streaming
  exhaustive tier, deletes and search again, each against numpy oracles;
- the binary kind at 524,288 x 768, the first half of the flat path's
  Gaussian corpus (a cut of scale from 1,048,576, for the limit):
  ``VectorDatabase(kind="binary")`` with its defaults (asym prescan) and a
  ``BinaryDeviceIndex(hamming_impl="popcount", prescan="hamming")``, whose
  prescan runs B6 (``csrc/hamming.cu``, on the b1 tensor cores), with
  Hamming-only search, the codes-only configuration, a filtered search and
  deletes;
- the kernel-free kinds at 131,072 rows each (a cut of scale, for the time
  limit): ``int8`` and ``pq`` on the Gaussian corpus, ``ivf_pq`` with each
  resident plane on the clustered IVF corpus (nlist 1024), and the projected
  ``ivf_int8_proj`` / ``ivf_int4_proj`` (R = 384, B4/B5) on a low-rank
  corpus;
- the graph kind (``kind="graph"``, the config defaults: degree 32, pool
  128, 12 NN-descent rounds) on the first 131,072 rows of the clustered
  corpus (a cut of scale from 1M: the reference's rule rebuilds the graph
  at every 25% of growth, about five full builds of host-side NN-descent
  joins over the ingest): ingest, ``optimize()``,
  search, filtered search, deletes and an upsert into the fresh region
  against the numpy oracle; its build, entry step and beam iterations run
  B11 (``csrc/gather.cu``): the build's 2048 x 576 calls through the
  grouped route (a grouping pass, then the persistent kernel), the search's
  through the pairs route, each route checked at all three shapes with the
  ids of a real build round and a real search and timed in turns with the
  other (the pairs route is the parent tree's kernel);
- the single-node server over the flat phase's database (handed on, not
  ingested again): the port's gRPC server (``build_grpc_server``) and REST
  server on 127.0.0.1, unfiltered searches from 32 client threads through
  the micro-batcher at k = 10 (B1) and k = 3 (B2), filtered and payload
  searches that skip it, REST searches, upserts over both protocols with
  searches in flight (the index grows to 2,097,152 rows), deletes, lookups,
  counts, health and metrics, each answer against the oracle over the
  index's rows; one batch under ``utils.tracing.profile_to``, whose Chrome
  trace must name ``segmax_max_kernel``; then B1 and B2 against their plain
  versions on the served plane at the batcher's largest batch (64);
- the CLI: ``python3 -m grape_vector_db_tpu_torch.cli serve`` as a
  subprocess on the default device, 16,384 x 768 rows over gRPC, searches
  against the numpy oracle, its /metrics' device memory, an interrupt; then
  every other subcommand in process at its defaults (their JSON keys held
  to the JAX CLI's) and ``tune`` on the served data directory;
- the embedded deployment at the default configuration: ``EmbeddedVectorDB``
  over a file store in a temporary directory with the device hash embedder
  (``embedding.provider = "device"``: 32,768 buckets, the JAX package's
  projection, checked on 4,096 entries against the numpy stream), 73,728
  synthetic text documents (a cut from 131,072, for the limit; the index
  grows to 131,072 rows) ingested through ``add_documents_pipelined`` on
  the device-direct path, the stored rows and the card's embeddings against
  the CPU port's, ``search_documents``, single queries from 32 threads through
  the batching executor, the B = 256 batch through B1 against the oracle over
  the index's rows and B1 against its plain version on the index's own plane,
  filters, the enterprise wrappers, index snapshot, backup
  and restore, close and reopen;
- the distributed tier: a ``ClusterService`` of 3 nodes, 16 shards, RF = 2
  (the reference CLI's ``serve`` defaults on the 3-node minimum its README
  names) over the default flat index at D = 768, every node's index on the
  card: 458,752 documents upserted with a session token (each node holds
  ~2/3 of them, so every shard-local leg runs B1 or B2), session searches
  from 32 threads through all three coordinators at k = 10 and 3,
  ``search_batch`` at B = 64, 1,024 deletes, node-3 failed (searches through
  node-1 stay exact) and recovered, each answer against the numpy oracle
  over the live documents, then B1 and B2 against their plain versions on
  node-1's plane; and three ``cli serve --node-id --peers`` processes on
  the card over gRPC: 8,192 rows (a cut of scale from 65,536, for the
  phase's budget) upserted at one, searched at another, one killed,
  searched at the third;
- the sharded kinds (``grape_vector_db_tpu_torch.parallel``: one process
  driving a mesh whose entries are all the one card): ``sharded_flat`` at
  the default configuration with ``device.n_shards = 4`` over 2,097,152
  seeded Gaussian documents (4 shards of 524,288 rows, so every shard's
  search runs B1 at k = 10 and B2 at k = 3), a 10% filter, 1,024 deletes and
  ``redistribute`` onto 2 shards, each answer against the numpy oracle; the
  sharded call's device span beside ``scored_topk`` on the same plane
  unsharded; a 2-D mesh (2 replica rows x 2 shards of 524,288) over the
  first 1,048,576 rows, its batch split 64 to a row, equal to the same
  shards searched 1-D; ``sharded_ivf`` / ``_int8`` / ``_int4`` over 4
  shards on the first 524,288 rows of each IVF kind's corpus (a cut for
  the phase's budget and the limit) right after the kind's own
  phase, first
  with its centroids (the same lists, its deletes: the same answers, the
  quantized kinds at least as good rank for rank), then ``optimize()``,
  search, both exact filter tiers, deletes, each against the numpy oracles,
  every probe running B3 / B4 / B5 once a shard; ``sharded_ivf_int8_proj``
  on the low-rank corpus (B4 at D = 384 on each shard); B1, B2 and B3-B5
  held against their plain versions on shard 0's own planes;
- the examples: each of the 15 scripts of ``examples_torch/`` (the port's
  counterparts of ``examples/``) in process at its own sizes with
  ``main(device="cuda")``, its stdout held against its run on the CPU in
  the same process under the rules of ``tests/examples_parity.py``;
  ``int8_ivf_demo`` and ``sharded_mesh_demo`` must launch B4,
  ``capacity_tier_demo`` B5, and B4 and B5 are held against their plain
  versions at D = 128 on the int8 bandwidth index's and the ``ivf_int4``
  index's own planes.

The asymmetric binary prescan's kernel (``csrc/asym.cu``, which replaces
no Pallas kernel: the JAX package left that decode and product to XLA) is
held against its plain version at the main path's shapes, q [8, 768] x
1,048,576 and 262,144 rows of sign codes, and timed beside its library
yardstick: the +-1 plane decoded once and kept on the card, one ``torch.mm``
a 262,144-row chunk.

B3, B4 and B5 are timed beside their nearest library composition (the probed
lists' rows gathered, B4's codes cast and B5's nibbles unpacked to bf16,
``torch.bmm`` with f32 out, multiply, where).

With ``--parent DIR`` (the parent commit's tree, unpacked), the hamming
phase and the int8 and int4 probes' main shapes also build the parent's
``csrc/hamming.cu`` and ``csrc/ivf_probe.cu`` and time the parent's kernels
(B6; the per-cell int8 kernel, format 2 of the parent's ``gvdb_ivf_probe``;
the grouped int4 one) in turns with this tree's (parent, change, change,
parent); without it those comparisons are skipped and logged as such.

Each path is driven with the launch counts set to 0 just before it and read
just after. Every phase raises on failure. Earlier lines report each phase;
the line before the last is a JSON object with one entry per kernel (B1's
entry carries its launches on the flat, server, embedded and cluster paths,
split under "launches_by_path", its check and times on the served plane
under "server", on the embedded index's plane under "embedded" and on a
cluster node's plane under "cluster", and on a shard's plane of the sharded
path under "sharded"; B2's its launches on the flat, server, cluster and
sharded paths and its served-plane, cluster-plane and shard-plane figures;
B3/B4/B5's entries carry their launches on the IVF and sharded paths (and
the sharded projected path's, B4) under "launches_by_path" and their check
on shard 0's lists under "sharded"; the projected path's own run
at D = 384 sits under their "d384" key, the examples' run at D = 128 under
"d128", and their launches in the examples under "examples" of
"launches_by_path" (B1's and B2's too); B4/B5's grouping pass has its own
entry, "ivf_group", whose launches are all those paths' with the split under
"launches_by_path"; B11 has one entry for the graph
search, with its entry step's shape under "entry", one for the build,
"gather_dots@build", and one for the build's grouping pass, "gather_group");
the last line is the JSON result. Without a CUDA
device, or without the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 1 << 20          # flat path: capacity 1,048,576
DIM = 768                 # the default configuration's vector_dimension
BATCH = 128               # the serving batch
INGEST_BATCH = 8192
TOL = 3e-3                # bf16 accumulation-order tolerance (ROADMAP)
SEED = 0
# the repository's 1M IVF configuration (bench.py:483-506)
IVF_ROWS = 1 << 20
IVF_CENTRES = 16_384
IVF_NOISE = 0.25
IVF_NLIST = 4096
NPROBE = 16               # the config default (config.py IndexConfig.nprobe)
# the quantized kinds: the same corpus unless the run needs the time
QUANT_ROWS = 1 << 20
QUANT_NLIST = 4096
# the binary kind: the first half of the flat path's corpus, a cut of scale
# from 1,048,576 to make room in the limit for the sharded phase (B6's
# 262,144-row chunk, its main shape, is kept)
BINARY_ROWS = N_ROWS // 2
HAMMING_CHECK_QUERIES = 16   # queries the numpy xor/popcount oracle checks
# the kernel-free kinds: cut to 262,144 rows each for the time limit, then to
# 131,072 to make room in the limit for the sharded phase
SMALL_ROWS = 1 << 17
HAMMING_ROWS = 262_144    # B6's main shape: one scan chunk of the binary index
IVFPQ_NLIST = 1024
PROJ_DIM = 384
LOWRANK_RANK = 320        # the low-rank corpus: a random 320-d subspace of R^768
LOWRANK_SPREAD = 0.25     # within-cluster spread inside the subspace
LOWRANK_NOISE = 0.02      # full-space noise
# the graph kind: the first 131,072 rows of the clustered corpus, a cut of
# scale from 1M for the reference's rebuild cascade (at 262,144 rows the
# phase took 276.5 s of its 240 s share of the limit on an H100)
GRAPH_ROWS = 1 << 17
GRAPH_BUDGET_S = 240.0
# the embedded deployment: a desktop or single-service corpus, cut from
# 131,072 to make room in the limit for the sharded phase; the index still
# grows to a capacity of 131,072, where a batch larger than 128 takes B1
EMBED_DOCS = 9 << 13
EMBED_VOCAB = 20_000
EMBED_BATCH = 256
EMBED_BUDGET_S = 240.0
EMBED_TOL = 1e-5          # the card's f32 embedding against the CPU port's

DEV = "cuda"              # where the port's tensors live
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak bandwidth
BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core peak

KERNELS = {
    # name: (source in the repo, the TPU kernel it replaces); B1 and B2 in
    # bf16 storage (the flat path's) run the TMA + wgmma kernel
    "segmax4": ("grape_vector_db_tpu_torch/csrc/segmax_max.cu",
                "grape_vector_db_tpu/ops/segmax_pallas.py:354"),
    "segmax2": ("grape_vector_db_tpu_torch/csrc/segmax_max.cu",
                "grape_vector_db_tpu/ops/segmax_pallas.py:124"),
    # B9, B10, B7, B8: the segment-max entry points' kernels; in bf16 storage
    # (the main path's) all four run the TMA + wgmma kernel
    "segmax": ("grape_vector_db_tpu_torch/csrc/segmax_max.cu",
               "grape_vector_db_tpu/ops/segmax_pallas.py:53"),
    "segmax_contig": ("grape_vector_db_tpu_torch/csrc/segmax_max.cu",
                      "grape_vector_db_tpu/ops/segmax_pallas.py:728"),
    "segmax4_sup": ("grape_vector_db_tpu_torch/csrc/segmax_max.cu",
                    "grape_vector_db_tpu/ops/segmax_pallas.py:401"),
    "segmax2_selfold": ("grape_vector_db_tpu_torch/csrc/segmax_max.cu",
                        "grape_vector_db_tpu/ops/segmax_pallas.py:237"),
    "ivf_probe": ("grape_vector_db_tpu_torch/csrc/ivf_probe.cu",
                  "grape_vector_db_tpu/ops/ivf_pallas.py:155"),
    "ivf_probe_int8": ("grape_vector_db_tpu_torch/csrc/ivf_probe.cu",
                       "grape_vector_db_tpu/ops/ivf_pallas.py:331"),
    "ivf_probe_int4": ("grape_vector_db_tpu_torch/csrc/ivf_probe.cu",
                       "grape_vector_db_tpu/ops/ivf_pallas.py:477"),
    # B4/B5's grouping pass (the int8 and int4 probes' cells sorted by list)
    # before their kernels
    "ivf_group": ("grape_vector_db_tpu_torch/csrc/ivf_probe.cu",
                  "grape_vector_db_tpu/ops/ivf_pallas.py:477"),
    "hamming": ("grape_vector_db_tpu_torch/csrc/hamming.cu",
                "grape_vector_db_tpu/ops/hamming_pallas.py:37"),
    # the asym prescan's scoring: no Pallas kernel (XLA fused the JAX
    # package's decode and product)
    "asym": ("grape_vector_db_tpu_torch/csrc/asym.cu",
             "none: grape_vector_db_tpu/ops/hamming.py asym_topk, left to XLA"),
    # B11 on the graph path: the search's launches (entry step, beam) and,
    # separately, the build's
    "gather_dots": ("grape_vector_db_tpu_torch/csrc/gather.cu",
                    "grape_vector_db_tpu/ops/gather_pallas.py:61"),
    "gather_dots@build": ("grape_vector_db_tpu_torch/csrc/gather.cu",
                          "grape_vector_db_tpu/ops/gather_pallas.py:61"),
    # B11's grouped route on the build: the grouping pass before its kernel
    "gather_group": ("grape_vector_db_tpu_torch/csrc/gather.cu",
                     "grape_vector_db_tpu/ops/gather_pallas.py:61"),
}
# the parent commit's tree (--parent): its B4 / B5 / B6 kernels are timed in turns
PARENT = None
# the card's name and power limit, as nvidia-smi gives them (set by setup())
CARD = None
# IVF kind -> the probe kernel its main search runs
IVF_KERNEL = {"ivf": "ivf_probe", "ivf_int8": "ivf_probe_int8", "ivf_int4": "ivf_probe_int4"}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(kern, plain, reps_k=10, reps_p=5):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps_p)
    k1 = cuda_ms(kern, reps_k)
    k2 = cuda_ms(kern, reps_k)
    p2 = cuda_ms(plain, reps_p)
    return (k1, k2), (p1, p2)


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak (bf16 tensor cores unless given), whichever
    is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ptxas_summary(build_log: str):
    """One line per compiled kernel from nvcc's -Xptxas -v output."""
    fmts = {"0": "bf16", "1": "f32", "2": "int8", "3": "int4"}
    # segmax_max_kernel<TOPJ, VARIANT> and segmax_kernel<TOPJ, VARIANT> -> the
    # LAUNCHES key of the instance
    segmax_names = {("4", "0"): "segmax4", ("2", "0"): "segmax2", ("1", "0"): "segmax",
                    ("1", "1"): "segmax_contig", ("2", "2"): "segmax2_selfold",
                    ("4", "3"): "segmax4_sup"}
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        mx = re.search(r"Compiling entry function '.*segmax_max_kernelILi(\d)ELi(\d)EE", line)
        m = re.search(r"Compiling entry function '.*segmax_kernelILi(\d)ELi(\d)EE", line)
        p = re.search(r"Compiling entry function '.*probe_kernelILi(\d)E+v", line)
        i4 = re.search(r"Compiling entry function '.*(int8_probe|int4_probe|grp\d+group)_kernel",
                       line)
        f = re.search(r"Compiling entry function '.*fill_kernel", line)
        h = re.search(r"Compiling entry function '.*hamming_mma_kernel", line)
        am = re.search(r"Compiling entry function '.*asym_mma_kernelILi(\d)E", line)
        g = re.search(r"Compiling entry function '.*gather_dots_kernelILi(\d)ELb(\d)E", line)
        gg = re.search(r"Compiling entry function '.*grouped_kernelILb(\d)E", line)
        gp = re.search(r"Compiling entry function '.*group\d+(dedup_count|offsets|scatter|expand)"
                       r"_kernel", line)
        if mx:
            name = f"{segmax_names[mx[1], mx[2]]}<bf16, TMA + wgmma>"
        elif m:
            name = f"{segmax_names[m[1], m[2]]}<f32>"
        elif f:
            name = "fill_kernel (segmax4_sup's -inf start)"
        elif p:
            name = f"ivf_probe<{fmts[p[1]]}>"
        elif i4:
            name = {"int8_probe": "ivf_probe_int8 (persistent, TMA ring, bf16 mma)",
                    "int4_probe": "ivf_probe_int4 (grouped, bf16 mma)"}.get(
                        i4[1], "ivf_group (int8 / int4 grouping pass)")
        elif h:
            name = "hamming (b1 mma)"
        elif am:
            name = f"asym (bf16 mma, {am[1]} n8 query tiles a warp)"
        elif g:
            name = (f"gather_dots pairs<{fmts[g[1]]}, "
                    f"{'16-byte' if g[2] == '1' else 'element'} loads>")
        elif gg:
            name = f"gather_dots grouped<{'16-byte' if gg[1] == '1' else 'element'} loads>"
        elif gp:
            name = f"gather grouping {gp[1]}_kernel"
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {regs} registers, {smem[1] if smem else 0} bytes static "
                       f"shared memory, {spill}")
            name = None
    return out


def reset_counts():
    from grape_vector_db_tpu_torch.ops import gather, hamming, ivf, segmax

    segmax.reset_launch_counts()
    ivf.reset_launch_counts()
    hamming.reset_launch_counts()
    gather.reset_launch_counts()


def read_counts() -> dict:
    from grape_vector_db_tpu_torch.ops import gather, hamming, ivf, segmax

    return {**segmax.LAUNCHES, **ivf.LAUNCHES, **hamming.LAUNCHES, **gather.LAUNCHES}


# -- set-up -----------------------------------------------------------------

# the parent's C entries of the grouped probes, and of their scratch size,
# under each name a tree has given them
PARENT_SCRATCH_WORDS = ("gvdb_ivf_scratch_words", "gvdb_ivf_int4_scratch_words")


def parent_lib(name: str) -> ctypes.CDLL:
    """The parent tree's ``csrc/<name>.cu`` (``--parent``), built with this
    tree's nvcc flags into this tree's ``_build/``, with its C entries bound:
    ``gvdb_hamming``, or ``gvdb_ivf_probe`` (whose format 2, where the parent
    has it, is the per-cell int8 probe) and, where the parent has them, the
    grouped ``gvdb_ivf_probe_int8`` / ``gvdb_ivf_probe_int4`` and their
    scratch size. Both of the parent's sources export
    ``gvdb_cuda_error_string``, as ``_build.load`` expects."""
    from grape_vector_db_tpu_torch.ops import _build

    def bind(lib):
        fn = lib.gvdb_hamming if name == "hamming" else lib.gvdb_ivf_probe
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] if name == "hamming" else
                       [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        if name == "hamming":
            return
        for entry in ("gvdb_ivf_probe_int8", "gvdb_ivf_probe_int4"):
            if hasattr(lib, entry):
                getattr(lib, entry).restype = ctypes.c_int
                getattr(lib, entry).argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        for entry in PARENT_SCRATCH_WORDS:
            if hasattr(lib, entry):
                getattr(lib, entry).restype = ctypes.c_long
                getattr(lib, entry).argtypes = [ctypes.c_int] * 4

    return _build.load(f"parent_{name}", bind,
                       os.path.join(PARENT, "grape_vector_db_tpu_torch", "csrc", f"{name}.cu"))


def setup():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        sys.exit(2)
    global CARD
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    CARD = smi
    log(smi)
    from grape_vector_db_tpu_torch.ops import _build, gather, hamming, ivf, segmax

    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc {nvcc}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    builds = (segmax.build_kernels, segmax.build_max_kernel, ivf.build_kernels,
              hamming.build_kernels, hamming.build_asym_kernel, gather.build_kernels)
    if PARENT:
        builds += (lambda: parent_lib("hamming"), lambda: parent_lib("ivf_probe"))
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:   # one nvcc per source
        for fut in [pool.submit(b) for b in builds]:
            fut.result()
    log(f"[setup] kernels built in {time.perf_counter() - t0:.2f} s (in parallel)"
        + (f"; the parent's B4, B5 and B6 from {PARENT}" if PARENT else ""))
    for name in ("segmax", "segmax_max", "ivf_probe", "hamming", "asym", "gather"):
        info = _build.BUILD_INFO[name]
        log(f"[setup] {name}: {info['library']}, {info['seconds']:.2f} s")
        for entry in ptxas_summary(str(info["log"])):
            log(f"[setup] ptxas {entry}")
    log(f"[setup] segmax_max: {segmax.build_max_kernel().gvdb_segmax_max_smem_bytes()} bytes "
        "of dynamic shared memory a block, one block an SM")
    for d in (DIM, PROJ_DIM):
        plan = (ctypes.c_int * 4)()
        require(ivf.build_kernels().gvdb_ivf_int8_plan(0, d, plan) == 0,
                "gvdb_ivf_int8_plan failed")
        log(f"[setup] ivf_probe_int8 at D={d}: {plan[0]} ring stages of 16 KB, {plan[1]} bytes "
            f"of dynamic shared memory a block, {plan[2]} blocks an SM, {plan[3]} threads a "
            "block")
    a = torch.ones(4, 8, device="cuda", dtype=torch.bfloat16)
    require(torch.mm(a, a.T, out_dtype=torch.float32).dtype == torch.float32,
            "torch.mm(bf16, bf16, out_dtype=float32) did not return float32")


# -- B1, B2 against their plain versions ----------------------------------------


def plane_check(name, got, want, n_vals):
    """Values within TOL; member indices equal where both neighbouring rank
    gaps exceed TOL. Returns the largest value difference."""
    vals = torch.stack([p.float() for p in got[:n_vals]])
    ref = torch.stack([p.float() for p in want[:n_vals]])
    require(torch.equal(torch.isneginf(vals), torch.isneginf(ref)),
            f"{name}: -inf positions differ")
    fin = torch.isfinite(ref)
    err = (vals - ref)[fin].abs().max().item()
    require(err <= TOL, f"{name}: max |value diff| {err} > {TOL}")
    checked = 0
    for t, (gi, wi) in enumerate(zip(got[n_vals:], want[n_vals:])):
        prev = ref[t - 1] if t else torch.full_like(ref[0], float("inf"))
        gap = torch.minimum(prev - ref[t], ref[t] - ref[t + 1]).nan_to_num(0.0)
        sure = gap > TOL
        bad = ((gi.long() != wi.long()) & sure).sum().item()
        require(bad == 0, f"{name}: {bad} member indices differ away from near ties")
        checked += sure.sum().item()
    log(f"[kernels] {name}: max_abs_err {err:.3g}, {checked} member indices "
        f"checked away from near ties, all equal")
    return err


def segmax_corpus():
    """The segment kernels' full-width inputs: [N_ROWS, DIM] bf16 Gaussian rows
    made on the card from SEED, 5% of them invalid, the cosine weight plane,
    and BATCH normalized queries."""
    from grape_vector_db_tpu_torch.ops import segmax

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    v = torch.randn(N_ROWS, DIM, device=dev, generator=gen).to(torch.bfloat16)
    valid = torch.rand(N_ROWS, device=dev, generator=gen) >= 0.05
    w = segmax.make_weight_plane(v.float().norm(dim=1), valid, "cosine")
    q = torch.nn.functional.normalize(torch.randn(BATCH, DIM, device=dev, generator=gen), dim=1)
    return v, valid, w, q


def integer_segments():
    """The exact-arithmetic adversarial case: small integers, so every sum is
    exact in f32 and ties are everywhere; duplicate rows inside one segment
    and one segment whose rows are all invalid. (q [40, 128], v [8192, 128]
    f32, w [8192]) on the card."""
    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED)
    vi = rng.integers(-2, 3, (8192, 128)).astype(np.float32)
    for m in (3, 7, 20):
        vi[4096 + 5 + 128 * m] = vi[77]
    qi = rng.integers(-2, 3, (40, 128)).astype(np.float32)
    wi = (rng.random(8192) >= 0.05).astype(np.float32)
    wi[[9 + 128 * m for m in range(32)]] = 0.0
    return (torch.from_numpy(qi).to(dev), torch.from_numpy(vi).to(dev),
            torch.from_numpy(wi).to(dev))


def segmax_phase():
    """B1 and B2 against their plain versions at the flat path's shapes, then
    on an exact-arithmetic adversarial case; also times both, in turns with
    their plain versions and with the nearest library composition."""
    from grape_vector_db_tpu_torch.ops import segmax

    v, valid, w, q = segmax_corpus()
    nseg, nblk = N_ROWS // 32, N_ROWS // 4096
    qb = q.to(torch.bfloat16)

    def library(topj):
        """The nearest library composition of B1 / B2: four calls, the [B, N]
        score plane materialized, the members last for torch.topk."""
        def fn():
            s = torch.mm(qb, v.T, out_dtype=torch.float32)
            s = torch.where(w[None, :] == 0, float("-inf"), s * w[None, :])
            return torch.topk(s.view(BATCH, nblk, 32, 128).transpose(2, 3), topj, dim=3)
        return fn

    out = {}
    for name, topj, kern, plain in (
            ("segmax4", 4, segmax.segmax4_scores, segmax.segmax4_scores_ref),
            ("segmax2", 2, segmax.segmax2_scores, segmax.segmax2_scores_ref)):
        got = kern(q, v, w)
        torch.cuda.synchronize()
        want = plain(q, v, w)
        if name == "segmax2":   # (m1, i1, m2) -> values first
            got, want = (got[0], got[2], got[1]), (want[0], want[2], want[1])
        err = plane_check(f"{name} [{BATCH},{DIM}] x [{N_ROWS},{DIM}] bf16", got, want, topj)
        lib = library(topj)
        lib_vals = lib().values.reshape(BATCH, nseg, topj)
        vals = torch.stack(got[:topj], dim=2)
        fin = torch.isfinite(vals)
        require(torch.equal(fin, torch.isfinite(lib_vals))
                and (lib_vals - vals)[fin].abs().max().item() <= TOL,
                f"{name}: the library composition computes another function")
        del lib_vals
        (k1, k2), (p1, p2) = in_turns(lambda: kern(q, v, w), lambda: plain(q, v, w))
        (k3, k4), (l1, l2) = in_turns(lambda: kern(q, v, w), lib, 10, 10)
        nbytes = (N_ROWS * DIM * 2 + N_ROWS * 4 + BATCH * DIM * 2
                  + (2 * topj - 1) * BATCH * nseg * 4)
        out[name] = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                     **bound(nbytes, 2.0 * BATCH * N_ROWS * DIM), "library_ms": (l1 + l2) / 2}
        log(f"[times] {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
            f"bound {out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']} "
            f"({nbytes / 1e9:.4f} GB; B={BATCH}, N={N_ROWS}, D={DIM}, bf16)")
        log(f"[times] {name}: library composition (torch.mm out_dtype=f32, multiply, where, "
            f"topk({topj}): 4 calls) {l1:.4f} / {l2:.4f} ms, in turns with the kernel "
            f"{k3:.4f} / {k4:.4f} ms")
    del v, valid, w, q, qb

    # exact arithmetic: every plane must match exactly
    qi, vi, wi = integer_segments()
    for dtype in (torch.bfloat16, torch.float32):
        vt = vi.to(dtype)
        for name, topj, kern, plain in (
                ("segmax4", 4, segmax.segmax4_scores, segmax.segmax4_scores_ref),
                ("segmax2", 2, segmax.segmax2_scores, segmax.segmax2_scores_ref)):
            got = kern(qi, vt, wi)
            torch.cuda.synchronize()
            for g, p in zip(got, plain(qi, vt, wi)):
                require(torch.equal(g.float(), p.float()),
                        f"{name} {dtype}: adversarial planes differ")
            log(f"[kernels] {name} {dtype} adversarial (ties, duplicates, invalid segment, "
                f"B=40; csrc/{segmax._library((topj, 'plain'), dtype)}.cu): every plane equal")
    return out


# -- B7-B10 and the segment-max entry points ----------------------------------------

# B7-B10: LAUNCHES key -> (label, the entry point that runs it, its options)
SEGMAX_ENTRY = {
    "segmax": ("segmax_topk(layout='strided')", "segmax_topk", {}),
    "segmax_contig": ("segmax_topk(layout='contig')", "segmax_topk", {"layout": "contig"}),
    "segmax4_sup": ("segmax4_topk(impl='sup')", "segmax4_topk", {"impl": "sup"}),
    "segmax2_selfold": ("segmax2_topk(impl='selfold')", "segmax2_topk", {"impl": "selfold"}),
}


def check_topk(name, vals, ids, o_vals, o_ids):
    """[B, k] (vals, ids) on the card against an oracle's: ids distinct and
    equal as sets up to near ties (TOL of the k-th score), values rank by
    rank within TOL, -inf where the oracle has it. Returns the largest
    value difference."""
    vals, ids = vals.double().cpu().numpy(), ids.long().cpu().numpy()
    o_vals, o_ids = o_vals.double().cpu().numpy(), o_ids.long().cpu().numpy()
    require(vals.shape == o_vals.shape, f"{name}: shape {vals.shape} vs {o_vals.shape}")
    require((np.isneginf(vals) == np.isneginf(o_vals)).all(), f"{name}: -inf positions differ")
    fin = np.isfinite(o_vals)
    err = float(np.abs(vals[fin] - o_vals[fin]).max())
    require(err <= TOL, f"{name}: values differ by {err} > {TOL}")
    for r in range(len(vals)):
        got = dict(zip(ids[r][fin[r]].tolist(), vals[r][fin[r]].tolist()))
        want = dict(zip(o_ids[r][fin[r]].tolist(), o_vals[r][fin[r]].tolist()))
        require(len(got) == fin[r].sum(), f"{name} q{r}: duplicate ids {ids[r]}")
        kth = o_vals[r][fin[r]].min()
        for i in set(got) ^ set(want):
            s = got.get(i, want.get(i))
            require(abs(s - kth) <= TOL, f"{name} q{r}: id {i} (score {s}) differs from the "
                    f"oracle away from the k-th score {kth}")
    return err


def segmax_variants_phase():
    """B9, B10, B7 and B8 against their plain versions at the flat path's
    shapes (1,048,576 x 768 bf16, B = 128, 5% of rows invalid) and on the
    exact-arithmetic case; then the entry points that run them, at k = 10
    and k = 3 and with a 10% filter, against the exact one-matmul oracle on
    the card and the plain engines (B1, B2), with the launch counts set to 0
    just before and read just after; then times. Returns (kernel stats,
    launches)."""
    from grape_vector_db_tpu_torch.ops import segmax
    from grape_vector_db_tpu_torch.ops.distance import prepare_queries, score_block

    t_phase = time.perf_counter()
    v, valid, w, q = segmax_corpus()
    norms = v.float().norm(dim=1)
    shape = f"[{BATCH},{DIM}] x [{N_ROWS},{DIM}] bf16"

    def selfold(q_, v_, w_):
        return segmax.segmax2_scores(q_, v_, w_, impl="selfold")

    def selfold_ref(q_, v_, w_):
        return segmax.segmax2_scores_ref(q_, v_, w_, impl="selfold")

    # name -> (wrapper, plain version, value planes, bytes it writes)
    nseg, nblk = N_ROWS // 32, N_ROWS // 4096
    kernels = {
        "segmax": (segmax.segmax_scores, segmax.segmax_scores_ref, 1, BATCH * nseg * 4),
        "segmax_contig": (segmax.segmax_scores_contig, segmax.segmax_scores_contig_ref, 1,
                          BATCH * nseg * 4),
        "segmax2_selfold": (selfold, selfold_ref, 2, 3 * BATCH * nseg * 4),
        "segmax4_sup": (segmax.segmax4_sup_scores, segmax.segmax4_sup_scores_ref, 4,
                        7 * BATCH * nseg * 4 + 2 * BATCH * nblk * 4),
    }
    errs = {}
    for name, (kern, plain, nv, _) in kernels.items():
        got = kern(q, v, w)
        torch.cuda.synchronize()
        want = plain(q, v, w)
        if name == "segmax_contig":          # [N/32, B]: the transposed twin
            got, want = (got.T,), (want.T,)
        elif name == "segmax":
            got, want = (got,), (want,)
        elif name == "segmax2_selfold":      # (m1, i1, m2) -> values first
            b2 = segmax.segmax2_scores(q, v, w)
            require(torch.equal(got[0], b2[0]) and torch.equal(got[2], b2[2]),
                    "segmax2_selfold: values differ from B2's on the same inputs")
            got, want = (got[0], got[2], got[1]), (want[0], want[2], want[1])
        else:                                # segmax4_sup: B1's planes, then s1, s2
            for t in (0, 1):
                require(torch.equal(got[7 + t], got[t].view(BATCH, nblk, 128).amax(dim=2)),
                        f"segmax4_sup: s{t + 1} is not the block maxima of its own m{t + 1}")
            require(all(torch.equal(a, b) for a, b in zip(got[:7], segmax.segmax4_scores(q, v, w))),
                    "segmax4_sup: planes differ from B1's on the same inputs")
            s_err = (torch.stack(got[7:]) - torch.stack(want[7:])).abs().max().item()
            require(s_err <= TOL, f"segmax4_sup: block maxima differ by {s_err}")
            got, want = got[:7], want[:7]
        errs[name] = plane_check(f"{name} {shape}", got, want, nv)
    log("[kernels] segmax4_sup: s1, s2 equal the block maxima of its own m1, m2, and its "
        "seven planes equal B1's; segmax2_selfold's values equal B2's")

    qi, vi, wi = integer_segments()
    for dtype in (torch.bfloat16, torch.float32):
        vt = vi.to(dtype)
        for name, (kern, plain, _, _) in kernels.items():
            got, want = kern(qi, vt, wi), plain(qi, vt, wi)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            require(all(torch.equal(g.float(), p.float()) for g, p in zip(got, want)),
                    f"{name} {dtype}: adversarial planes differ")
        diff = (selfold(qi, vt, wi)[1] != segmax.segmax2_scores(qi, vt, wi)[1]).sum().item()
        require(diff > 0, "segmax2_selfold: i1 equals B2's everywhere on the tie case")
        log(f"[kernels] segmax, segmax_contig, segmax4_sup, segmax2_selfold {dtype} adversarial "
            f"(B=40; csrc/{segmax._library((1, 'plain'), dtype)}.cu): every plane equal; "
            f"selfold's i1 differs from B2's at {diff} ties")

    # the entry points: this phase's main path, each call one launch of its kernel
    rng = np.random.default_rng(SEED + 21)
    allowed = torch.from_numpy(rng.random(N_ROWS) < 0.1).to(v.device)
    queries = torch.from_numpy(rng.standard_normal((BATCH, DIM), dtype=np.float32)).to(v.device)
    calls = [(name, k, m) for name in SEGMAX_ENTRY
             for k, m in ((10, None), (3, None), (10, allowed))]
    results = {}
    reset_counts()
    for name, k, m in calls:
        label, fn, kw = SEGMAX_ENTRY[name]
        before = dict(segmax.LAUNCHES)
        results[name, k, m is None] = getattr(segmax, fn)(queries, v, norms, valid, k=k,
                                                          mask=m, **kw)
        torch.cuda.synchronize()
        delta = {key: segmax.LAUNCHES[key] - before[key] for key in before}
        require(delta[name] == 1 and sum(delta.values()) == 1,
                f"{label} k={k}: launches {delta}, wanted one of {name}")
    counts = read_counts()
    launches = {name: counts[name] for name in SEGMAX_ENTRY}
    log(f"[segmax entry] {len(calls)} calls (4 entry points x k=10, k=3, k=10 with a 10% "
        f"filter) at {N_ROWS} x {DIM}, B={BATCH}; launches {launches}")

    qp = prepare_queries(queries, "cosine")
    oracle = {}
    for unfiltered, m in ((True, None), (False, allowed)):
        s = score_block(qp, v, norms, valid if m is None else valid & m, "cosine")
        oracle[unfiltered] = torch.topk(s, 10, dim=1)
        del s
    plain_engines = {}
    for k, unfiltered in ((10, True), (3, True), (10, False)):
        m = None if unfiltered else allowed
        plain_engines["segmax4_sup", k, unfiltered] = segmax.segmax4_topk(
            queries, v, norms, valid, k=k, mask=m)
        plain_engines["segmax2_selfold", k, unfiltered] = segmax.segmax2_topk(
            queries, v, norms, valid, k=k, mask=m)
    worst = 0.0
    for (name, k, unfiltered), (vals, ids) in results.items():
        o_vals, o_ids = oracle[unfiltered]
        tag = f"{SEGMAX_ENTRY[name][0]} k={k}{'' if unfiltered else ' filtered 10%'}"
        worst = max(worst, check_topk(tag, vals, ids, o_vals[:, :k], o_ids[:, :k]))
        if not unfiltered:
            require(bool(allowed[ids.long()].all()), f"{tag}: a result broke the filter")
        if (name, k, unfiltered) in plain_engines:
            check_topk(f"{tag} against impl='plain' / 'eqfold'", vals, ids,
                       *plain_engines[name, k, unfiltered])
    log(f"[segmax entry] every answer agrees with the exact oracle (score_block + torch.topk "
        f"on the card) and with impl='plain' / 'eqfold': ids as sets up to near ties, values "
        f"within {TOL} (largest difference {worst:.3g}); filtered results obey the filter")

    out = {}
    for name, (kern, plain, _, written) in kernels.items():
        (k1, k2), (p1, p2) = in_turns(lambda: kern(q, v, w), lambda: plain(q, v, w))
        nbytes = N_ROWS * DIM * 2 + N_ROWS * 4 + BATCH * DIM * 2 + written
        out[name] = {"max_abs_err": errs[name], "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                     **bound(nbytes, 2.0 * BATCH * N_ROWS * DIM), "library_ms": None}
        log(f"[times] {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
            f"bound {out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']} "
            f"({nbytes / 1e9:.4f} GB; B={BATCH}, N={N_ROWS}, D={DIM}, bf16)")

    # the nearest library composition of B9 and B10: four calls, the [B, N]
    # score plane materialized
    def lib_strided(qb):
        s = torch.mm(qb.to(torch.bfloat16), v.T, out_dtype=torch.float32)
        s = torch.where(w[None, :] == 0, float("-inf"), s * w[None, :])
        return s.view(len(qb), nblk, 32, 128).amax(dim=2).view(len(qb), nseg)

    def lib_contig(qb):
        s = torch.mm(v, qb.to(torch.bfloat16).T, out_dtype=torch.float32)
        s = torch.where(w[:, None] == 0, float("-inf"), s * w[:, None])
        return s.view(nseg, 32, len(qb)).amax(dim=1)

    # at BATCH (the JSON line's row), then at B = 256, scored_topk's cap, where
    # two query tiles share each corpus tile through L2
    gen = torch.Generator(device=v.device).manual_seed(SEED + 256)
    q256 = torch.nn.functional.normalize(torch.randn(256, DIM, device=v.device, generator=gen),
                                         dim=1)
    for qb in (q, q256):
        for name, fn, kern in (("segmax", lib_strided, segmax.segmax_scores),
                               ("segmax_contig", lib_contig, segmax.segmax_scores_contig)):
            ref = kern(qb, v, w)
            lib = fn(qb)
            fin = torch.isfinite(ref)
            require(torch.equal(fin, torch.isfinite(lib))
                    and (lib - ref)[fin].abs().max().item() <= TOL,
                    f"{name}: the library composition computes another function")
            (k1, k2), (l1, l2) = in_turns(lambda: kern(qb, v, w), lambda: fn(qb), 10, 10)
            if qb is q:
                out[name]["library_ms"] = (l1 + l2) / 2
            log(f"[times] {name} B={len(qb)}: library composition (torch.mm out_dtype=f32, "
                f"multiply, where, amax: 4 calls) {l1:.4f} / {l2:.4f} ms, in turns with the "
                f"kernel {k1:.4f} / {k2:.4f} ms")

    # B7 and B8 in turns with B1 / B2 (the same main loop, another epilogue)
    # and with the nearest library composition of each: B1's / B2's four
    # calls, then amax over each block's segments (B7), or the members
    # permuted into bit-reversed order before topk (B8: the same values; its
    # i1 may differ from B8's on ties, as topk does not promise an order)
    order = torch.tensor(segmax._SELFOLD_ORDER, device=v.device)

    def lib_scores(qb):
        s = torch.mm(qb.to(torch.bfloat16), v.T, out_dtype=torch.float32)
        s = torch.where(w[None, :] == 0, float("-inf"), s * w[None, :])
        return s.view(len(qb), nblk, 32, 128).transpose(2, 3)

    def lib_sup(qb):
        top = torch.topk(lib_scores(qb), 4, dim=3)
        return top.values, top.values[..., :2].amax(dim=2)

    def lib_selfold(qb):
        return torch.topk(lib_scores(qb)[..., order], 2, dim=3).values, None

    twins = {"segmax4_sup": (segmax.segmax4_sup_scores, segmax.segmax4_scores, lib_sup, "B1"),
             "segmax2_selfold": (selfold, segmax.segmax2_scores, lib_selfold, "B2")}
    for qb in (q, q256):
        for name, (kern, twin, fn, twin_name) in twins.items():
            got = kern(qb, v, w)
            lib_vals, lib_sup_vals = fn(qb)
            planes = got[:4] if name == "segmax4_sup" else (got[0], got[2])
            vals = torch.stack(planes, dim=2).view(lib_vals.shape)
            fin = torch.isfinite(vals)
            ok = (torch.equal(fin, torch.isfinite(lib_vals))
                  and (lib_vals - vals)[fin].abs().max().item() <= TOL)
            if lib_sup_vals is not None:
                sup = torch.stack(got[7:9], dim=2)
                fin = torch.isfinite(sup)
                ok = ok and (torch.equal(fin, torch.isfinite(lib_sup_vals))
                             and (lib_sup_vals - sup)[fin].abs().max().item() <= TOL)
            require(ok, f"{name}: the library composition computes another function")
            del got, lib_vals, lib_sup_vals, vals, planes
            (k1, k2), (t1, t2) = in_turns(lambda: kern(qb, v, w), lambda: twin(qb, v, w), 10, 10)
            (k3, k4), (l1, l2) = in_turns(lambda: kern(qb, v, w), lambda: fn(qb), 10, 10)
            if qb is q:
                out[name]["library_ms"] = (l1 + l2) / 2
            written = kernels[name][3] * len(qb) // BATCH
            bnd = bound(N_ROWS * DIM * 2 + N_ROWS * 4 + len(qb) * DIM * 2 + written,
                        2.0 * len(qb) * N_ROWS * DIM)["bound_ms"]
            log(f"[times] {name} B={len(qb)}: kernel {k1:.4f} / {k2:.4f} ms (bound "
                f"{bnd:.4f} ms) in turns with {twin_name} {t1:.4f} / {t2:.4f} ms; library "
                f"composition (torch.mm "
                f"out_dtype=f32, multiply, where, "
                f"{'topk(4), amax' if name == 'segmax4_sup' else 'index, topk(2)'}: 5 calls) "
                f"{l1:.4f} / {l2:.4f} ms, in turns with the kernel {k3:.4f} / {k4:.4f} ms")
    del q256

    m1, _, _, _, _, _, _, s1, _ = segmax.segmax4_sup_scores(q, v, w)
    for kk in (10, 3):
        def two():
            return segmax._twolevel_topk_pre(m1, kk, s1)

        def full():
            return torch.topk(m1, kk, dim=1)

        (t1, t2), (f1, f2) = in_turns(two, full, 20, 20)
        log(f"[times] sup selection k={kk} over m1 [{BATCH},{nseg}]: two-level from s1 "
            f"{t1:.4f} / {t2:.4f} ms, torch.topk on the full plane {f1:.4f} / {f2:.4f} ms")
    for name, (label, fn, kw) in SEGMAX_ENTRY.items():
        def call():
            return getattr(segmax, fn)(queries, v, norms, valid, k=10, **kw)

        ms = cuda_ms(call, 10)
        # the host's clock over issuing 10 calls (no call waits on the card):
        # near the card's time, the host's launches bound the entry point
        t0 = time.perf_counter()
        for _ in range(10):
            call()
        issue_ms = (time.perf_counter() - t0) * 100
        torch.cuda.synchronize()
        log(f"[times] {label} k=10 B={BATCH} at {N_ROWS} x {DIM}: {ms:.4f} ms on the card "
            f"(phase 1 {out[name]['ms']:.4f} ms of it); the host issues a call in "
            f"{issue_ms:.4f} ms")
    del v, valid, w, q, norms
    log(f"[time] segmax variants phase {time.perf_counter() - t_phase:.1f} s")
    return out, launches


# -- B3, B4, B5 on an adversarial case ------------------------------------------


def probe_adversarial():
    """Every probe format against its plain version on small-integer data,
    so every sum is exact and every plane must be equal: ragged nblocks (0,
    an odd count, a count past the capacity), weights zeroed inside a list,
    duplicate probe ids, C = 128; at D = 128 and at D = 384, the width the
    projected kinds run B4/B5 at (int4: 192 packed bytes a row)."""
    from grape_vector_db_tpu_torch.ops import ivf as tivf
    from grape_vector_db_tpu_torch.ops.int4 import quantize_int4

    dev = torch.device(DEV)
    for d in (128, PROJ_DIM):
        rng = np.random.default_rng(SEED + 7 + d)
        n_lists, cap, b, p = 8, 128, 40, 6
        x = rng.integers(-3, 4, (n_lists, cap, d)).astype(np.float32)
        q = torch.from_numpy(rng.integers(-3, 4, (b, d)).astype(np.float32)).to(dev)
        nb = torch.tensor([2, 1, 0, 2, 1, 3, 2, 1], dtype=torch.int32, device=dev)
        w = rng.choice([0.5, 1.0, 2.0], (n_lists, cap)).astype(np.float32)
        w[0, 10:30] = 0.0
        w[3, 64:70] = 0.0
        w = torch.from_numpy(w).to(dev)
        probe = torch.from_numpy(rng.integers(0, n_lists, (b, p)).astype(np.int32)).to(dev)
        probe[:, 1] = probe[:, 0]                                    # duplicates
        xt = torch.from_numpy(x).to(dev)
        cases = [
            ("ivf_probe", "bf16", tivf.ivf_probe_scores, tivf.ivf_probe_scores_ref,
             xt.to(torch.bfloat16)),
            ("ivf_probe", "f32", tivf.ivf_probe_scores, tivf.ivf_probe_scores_ref, xt),
            ("ivf_probe_int8", "int8", tivf.ivf_probe_scores_int8,
             tivf.ivf_probe_scores_int8_ref, xt.to(torch.int8)),
            ("ivf_probe_int4", "int4", tivf.ivf_probe_scores_int4,
             tivf.ivf_probe_scores_int4_ref,
             quantize_int4(xt.reshape(-1, d))[0].reshape(n_lists, cap, d // 2)),
        ]
        for name, fmt, kern, plain, data in cases:
            got = kern(q, probe, data, w, nb)
            torch.cuda.synchronize()
            want = plain(q, probe, data, w, nb)
            require(torch.equal(got, want), f"{name} {fmt} D={d}: adversarial scores differ "
                    f"(max {(got - want).abs().max().item()})")
            require(bool((got[probe == 2] == -1e9).all()),
                    f"{name} {fmt} D={d}: nblocks 0 not honoured")
            log(f"[kernels] {name} {fmt} adversarial (ragged nblocks incl. 0, zero weights, "
                f"duplicate probes, C={cap}, B={b}, P={p}, D={d}): every score equal")
    # B5's groups: one list probed by 21 cells (split into groups of up to
    # 8), every cell on one list, ids outside [0, L) (-1e9 on their cells),
    # D = 32
    for d, kind in ((32, "split"), (128, "one list"), (384, "bad ids")):
        rng = np.random.default_rng(SEED + 11 + d)
        n_lists, cap, b, p = 8, 128, 24, 6
        x = rng.integers(-3, 4, (n_lists * cap, d)).astype(np.float32)
        data = quantize_int4(torch.from_numpy(x).to(dev))[0].reshape(n_lists, cap, d // 2)
        q = torch.from_numpy(rng.integers(-3, 4, (b, d)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.choice([0.0, 0.5, 1.0, 2.0], (n_lists, cap))
                             .astype(np.float32)).to(dev)
        nb = torch.tensor([2, 1, 0, 2, 1, 3, 2, -1], dtype=torch.int32, device=dev)
        probe = torch.from_numpy(rng.integers(0, n_lists, (b, p)).astype(np.int32)).to(dev)
        if kind == "split":
            probe.view(-1)[:21] = 3
        elif kind == "one list":
            probe[:] = 5
        else:
            probe[0, 2], probe[3, 4], probe[7, 0] = -1, n_lists, 1 << 30
        got = tivf.ivf_probe_scores_int4(q, probe, data, w, nb)
        torch.cuda.synchronize()
        bad = (probe < 0) | (probe >= n_lists)
        want = tivf.ivf_probe_scores_int4_ref(q, probe, data, w, nb)
        require(torch.equal(got, want) and bool((got[bad] == -1e9).all()),
                f"ivf_probe_int4 {kind} D={d}: grouped scores differ from the plain version")
        log(f"[kernels] ivf_probe_int4 grouping case '{kind}' (D={d}, B={b}, P={p}): every "
            f"score equal")
    # B4's groups, with codes over all of [-128, 127]: the same four ways to
    # group (and nblocks 0, negative and past the capacity) at D = 16, 128
    # and 384
    for d, kind in itertools.product((16, 128, PROJ_DIM), ("split", "one list", "bad ids",
                                                          "nblocks")):
        rng = np.random.default_rng(SEED + 13 + d)
        n_lists, cap, b, p = 8, 128, 24, 6
        data = torch.from_numpy(rng.integers(-128, 128, (n_lists, cap, d)).astype(np.int8)).to(dev)
        q = torch.from_numpy(rng.integers(-3, 4, (b, d)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.choice([0.0, 0.5, 1.0, 2.0], (n_lists, cap))
                             .astype(np.float32)).to(dev)
        nb = torch.tensor([2, 1, 0, 2, 1, 3, 2, -1], dtype=torch.int32, device=dev)
        probe = torch.from_numpy(rng.integers(0, n_lists, (b, p)).astype(np.int32)).to(dev)
        if kind == "split":
            probe.view(-1)[:21] = 3
        elif kind == "one list":
            probe[:] = 5
        elif kind == "bad ids":
            probe[0, 2], probe[3, 4], probe[7, 0] = -1, n_lists, 1 << 30
        else:
            nb = torch.tensor([0, -3, 0, 5, 1, 3, 2, 100], dtype=torch.int32, device=dev)
        got = tivf.ivf_probe_scores_int8(q, probe, data, w, nb)
        torch.cuda.synchronize()
        bad = (probe < 0) | (probe >= n_lists) | (nb.clamp(min=0)[probe.clamp(0, n_lists - 1)
                                                                  .long()] == 0)
        want = tivf.ivf_probe_scores_int8_ref(q, probe, data, w, nb)
        require(torch.equal(got, want) and bool((got[bad] == -1e9).all()),
                f"ivf_probe_int8 {kind} D={d}: grouped scores differ from the plain version")
        log(f"[kernels] ivf_probe_int8 grouping case '{kind}' (D={d}, B={b}, P={p}): every "
            f"score equal, bad cells -1e9 throughout")
    # every byte value at every position of a 16-byte chunk against one-hot
    # queries: each score is the byte itself
    d, cap = 128, 256
    codes = ((torch.arange(cap)[:, None] + torch.arange(d)[None, :]) % 256 - 128).to(torch.int8)
    codes = codes.reshape(1, cap, d).to(dev)
    q = torch.eye(d, device=dev)
    probe = torch.zeros((d, 1), dtype=torch.int32, device=dev)
    w = torch.ones((1, cap), device=dev)
    nb = torch.tensor([cap // 64], dtype=torch.int32, device=dev)
    got = tivf.ivf_probe_scores_int8(q, probe, codes, w, nb)
    torch.cuda.synchronize()
    require(torch.equal(got, tivf.ivf_probe_scores_int8_ref(q, probe, codes, w, nb))
            and torch.equal(got[:, 0, :], codes[0].T.float()),
            "ivf_probe_int8: the byte -> bf16 route is not exact on every byte")
    log(f"[kernels] ivf_probe_int8 on all 256 byte values x {d} positions (one-hot queries): "
        "equal to the plain version bit for bit")


# -- B6 against its plain version -------------------------------------------------


def random_words(gen, rows: int, w: int, dev) -> torch.Tensor:
    return torch.randint(-2**31, 2**31, (rows, w), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)


def hamming_phase():
    """B6 against its plain version, integer for integer: at the main shape
    (the binary index's 262,144-row scan chunk at B=128, D=768; and at
    B=256) and on adversarial shapes and bit patterns; times the kernel, the
    plain version and the mxu route (+-1 decode + torch.mm) in turns, and,
    with --parent, the parent's kernel in turns with this one."""
    from grape_vector_db_tpu_torch.ops import hamming
    from tools import mma_rates

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, c, w = BATCH, HAMMING_ROWS, DIM // 32
    q = random_words(gen, 2 * b, w, dev)
    codes = random_words(gen, c, w, dev)
    for bb in (b, 2 * b):
        got = hamming.hamming_popcount(q[:bb], codes)
        torch.cuda.synchronize()
        want = hamming.hamming_scores_ref(q[:bb], codes)
        require(torch.equal(got, want),
                f"hamming: kernel and plain version differ at the main shape, B={bb}")
    del got
    mxu = hamming.hamming_scores(q[:b], codes, impl="mxu")
    require(torch.equal(mxu, want[:b]), "hamming: the mxu route differs from the plain version")
    del mxu, want
    log(f"[kernels] hamming [{b},{w}] (and [{2 * b},{w}]) x [{c},{w}] int32 words: equal to "
        f"the plain version and to the mxu route, integer for integer")
    patterns = {"zeros": 0, "ones": -1, "alternating": 0x55555555}
    n_cases = 0
    for bb, cc, ww in ((1, 1, 1), (129, c - 1, 24), (1, c - 1, 3), (129, 1, 3),
                       (128, 4097, 1), (7, 513, 24), (130, 4098, 48), (3, 777, 70)):
        for pat in ("random", "zeros", "ones", "alternating"):
            qq = random_words(gen, bb, ww, dev)
            if pat == "random":
                cw = random_words(gen, cc, ww, dev)
            else:
                cw = torch.full((cc, ww), patterns[pat], dtype=torch.int32, device=dev)
                if pat == "alternating":
                    cw[1::2] = ~cw[1::2]          # 0x55555555 / 0xAAAAAAAA rows
                    qq[0] = cw[0]
            g2 = hamming.hamming_popcount(qq, cw)
            torch.cuda.synchronize()
            require(torch.equal(g2, hamming.hamming_scores_ref(qq, cw)),
                    f"hamming: B={bb} C={cc} W={ww} {pat}: kernel and plain version differ")
            n_cases += 1
    log(f"[kernels] hamming adversarial: {n_cases} cases (C = {c - 1:,}, 4098, 4097, 777, 513 "
        f"and 1; W = 1, 3, 24, 48, 70; B = 1, 3, 7, 128, 129, 130; random, all-zero, all-one, "
        f"alternating words): every distance equal")
    qb = q[:b].contiguous()
    (k1, k2), (p1, p2) = in_turns(lambda: hamming.hamming_popcount(qb, codes),
                                  lambda: hamming.hamming_scores_ref(qb, codes), 20, 3)
    l1 = cuda_ms(lambda: hamming.hamming_scores(qb, codes, impl="mxu"), 10)
    # The same distances are a +-1 product (dot = D - 2 * hamming, exact in
    # int8 with int32 sums): 2 operations a bit pair at the int8 tensor-core peak.
    nbytes = b * w * 4 + c * w * 4 + b * c * 4
    ops = 2.0 * b * c * w * 32
    stats = {"max_abs_err": 0.0, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
             **bound(nbytes, ops, INT8_OPS_PER_S), "library_ms": l1}
    rate = mma_rates.b1_rate()
    n_mma = b * c * w / 1024
    log(f"[times] hamming: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, mxu "
        f"route (decode + torch.mm) {l1:.4f} ms; bound {stats['bound_ms']:.4f} ms by "
        f"{stats['bound_by']} (bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {ops:.3g} "
        f"+-1 int8 operations {ops / INT8_OPS_PER_S * 1e3:.4f} ms); the b1 route's "
        f"tensor-core floor {n_mma / rate * 1e3:.4f} ms ({n_mma:.6g} mma.sync m16n8k256 at "
        f"{rate:.4g} a second, measured by tools/mma_rates.py) (B={b}, C={c}, W={w})")
    stats["b256_ms"] = cuda_ms(lambda: hamming.hamming_popcount(q, codes), 20)
    log(f"[times] hamming at B={2 * b}: kernel {stats['b256_ms']:.4f} ms; bound "
        f"{bound(2 * nbytes - c * w * 4, 2 * ops, INT8_OPS_PER_S)['bound_ms']:.4f} ms by bytes")
    if PARENT:
        stats["parent_ms"] = {}
        for bb in (b, 2 * b):
            qq = q[:bb].contiguous()
            out = torch.empty((bb, c), dtype=torch.int32, device=dev)
            lib = parent_lib("hamming")
            stream = torch.cuda.current_stream().cuda_stream

            def parent():
                lib.gvdb_hamming(0, qq.data_ptr(), codes.data_ptr(), out.data_ptr(), bb, c, w,
                                 stream)

            parent()
            torch.cuda.synchronize()
            require(torch.equal(out, hamming.hamming_popcount(qq, codes)),
                    "hamming: the parent's kernel and this one differ")
            (n1, n2), (o1, o2) = in_turns(lambda: hamming.hamming_popcount(qq, codes), parent,
                                          20, 20)
            stats["parent_ms"][f"B={bb}"] = [o1, n1, n2, o2]
            log(f"[times] hamming against the parent's kernel at B={bb}, in turns (parent, "
                f"change, change, parent): {o1:.4f} / {n1:.4f} / {n2:.4f} / {o2:.4f} ms")
            del out
    else:
        log("[times] hamming: the parent's kernel not timed (no --parent)")
    return stats


# -- the asym prescan's kernel against its plain version -----------------------------


def asym_phase():
    """The asym kernel against its plain version at the main path's shapes:
    q [8, 768] bf16 (a serial search padded to 8) x 1,048,576 rows of sign
    codes (the binary index's capacity, one launch) and x 262,144 (a chunk);
    each score within the f32 order bound 2 * D * 2^-24 * sum |q|, invalid
    rows exactly -inf. Times the kernel and the plain version in turns and the
    library yardstick: the +-1 plane decoded once and kept on the card (1.5 GB
    at 1M rows), one torch.mm a 262,144-row chunk."""
    from grape_vector_db_tpu_torch.ops import hamming

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    b, c, d = 8, N_ROWS, DIM
    w = hamming.words_per_vector(d)
    q = torch.randn((b, d), generator=gen, device=dev)
    qb = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    codes = random_words(gen, c, w, dev)
    valid = torch.rand(c, generator=gen, device=dev) > 0.05
    tol = 2 * d * 2.0**-24 * float(qb.float().abs().sum(dim=1).max())
    stats = {}
    for rows in (c, HAMMING_ROWS):
        cc, vv = codes[:rows], valid[:rows]
        before = hamming.LAUNCHES["asym"]
        got = hamming.asym_scores(qb, cc, vv)
        torch.cuda.synchronize()
        require(hamming.LAUNCHES["asym"] == before + 1, "asym: one call, one launch")
        want = hamming.asym_scores_ref(qb, cc, vv)
        fin = torch.isfinite(want)
        require(torch.equal(fin, torch.isfinite(got)) and bool((got[~fin] == -np.inf).all()),
                f"asym at {rows} rows: the invalid rows differ")
        err = float((got - want).abs()[fin].max())
        require(err <= tol, f"asym at {rows} rows: gap {err:.3g} above the bound {tol:.3g}")
        del got, want
        (k1, k2), (p1, p2) = in_turns(lambda: hamming.asym_scores(qb, cc, vv),
                                      lambda: hamming.asym_scores_ref(qb, cc, vv), 20, 3)
        # bytes: the codes and validity read once, the query, the f32 plane
        # written; the +-1 product at the bf16 peak
        nbytes = rows * (w * 4 + 1) + b * d * 2 + b * rows * 4
        entry = {"max_abs_err": err, "bound_of_err": tol, "ms": (k1 + k2) / 2,
                 "plain_ms": (p1 + p2) / 2, **bound(nbytes, 2.0 * b * rows * d)}
        plane = hamming._unpack_signs(cc)[:, :d]
        step = HAMMING_ROWS
        entry["library_ms"] = cuda_ms(lambda: [
            torch.mm(qb, plane[lo:lo + step].T, out_dtype=torch.float32)
            for lo in range(0, rows, step)], 10)
        del plane
        stats[rows] = entry
        log(f"[kernels] asym [{b},{d}] bf16 x [{rows},{w}] words: within {err:.3g} of the plain "
            f"version (bound {tol:.3g}), invalid rows -inf")
        log(f"[times] asym at {rows} rows: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
            f"{p2:.4f} ms, library (the plane kept, torch.mm a {step}-row chunk) "
            f"{entry['library_ms']:.4f} ms; bound {entry['bound_ms']:.4f} ms by "
            f"{entry['bound_by']}")
    main, chunk = stats[c], stats[HAMMING_ROWS]
    return {**main, "rows": c, f"at_{HAMMING_ROWS}": chunk}


# -- the flat path ----------------------------------------------------------------


def corpus_batches():
    rng = np.random.default_rng(SEED)
    for start in range(0, N_ROWS, INGEST_BATCH):
        yield start, rng.standard_normal((INGEST_BATCH, DIM), dtype=np.float32)


def oracle(batches, queries, group_of, deep=64):
    """numpy f32 cosine over the bf16-rounded corpus: per query the top
    ``deep`` (score, row) overall and among rows with group 3."""
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    best = [np.full((len(qn), 0), -np.inf), np.zeros((len(qn), 0), np.int64)]
    best_f = [np.full((len(qn), 0), -np.inf), np.zeros((len(qn), 0), np.int64)]

    def merge(acc, s, rows):
        vals = np.concatenate([acc[0], s], axis=1)
        ids = np.concatenate([acc[1], np.broadcast_to(rows, s.shape)], axis=1)
        top = np.argpartition(-vals, deep - 1, axis=1)[:, :deep]
        acc[0] = np.take_along_axis(vals, top, axis=1)
        acc[1] = np.take_along_axis(ids, top, axis=1)

    for start, x in batches:
        xr = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        s = (qn @ xr.T) / np.linalg.norm(xr, axis=1)[None, :]
        rows = np.arange(start, start + len(x))
        merge(best, s, rows)
        g3 = group_of(rows) == 3
        merge(best_f, s[:, g3], rows[g3])
    out = []
    for vals, ids in (best, best_f):
        order = np.argsort(-vals, axis=1)
        out.append((np.take_along_axis(vals, order, axis=1),
                    np.take_along_axis(ids, order, axis=1)))
    return out


def check_hits(name, hits, o_vals, o_ids, k, exclude=frozenset()):
    """Result ids as a set against the oracle's, with the near-tie guard."""
    for r, row in enumerate(hits):
        want = [(int(i), float(s)) for i, s in zip(o_ids[r], o_vals[r])
                if int(i) not in exclude][:k]
        require(len(want) == k, f"{name}: oracle too shallow")
        got = {int(p.id[3:]): p.score for p in row}
        require(len(row) == k and len(got) == k, f"{name} q{r}: {len(row)} hits, duplicates?")
        require(not set(got) & exclude, f"{name} q{r}: a deleted id came back")
        kth = want[-1][1]
        ref = dict(want)
        for i in set(got) ^ set(ref):
            s = got.get(i, ref.get(i))
            require(abs(s - kth) <= TOL,
                    f"{name} q{r}: id {i} (score {s}) differs from the oracle away "
                    f"from the k-th score {kth}")
        for i in set(got) & set(ref):
            require(abs(got[i] - ref[i]) <= TOL,
                    f"{name} q{r}: score of {i} {got[i]} vs oracle {ref[i]}")


def timed(fn, reps=20):
    """Median host seconds of fn() over reps calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def flat_path():
    from grape_vector_db_tpu_torch import (Condition, Document, Filter, SearchRequest,
                                           VectorDatabase, VectorDbConfig)

    def group_of(rows):
        return rows % 10

    db = VectorDatabase(config=VectorDbConfig(vector_dimension=DIM), device=DEV)
    log(f"[flat] VectorDatabase: index {db.index.kind}, metric {db.index.metric}, "
        f"storage {db.index.storage_dtype}, device {db.index.device}")
    rng = np.random.default_rng(SEED + 1)
    # half the queries lie near stored documents, half anywhere
    near = rng.choice(N_ROWS, BATCH // 2, replace=False)
    queries = np.empty((BATCH, DIM), np.float32)
    queries[BATCH // 2:] = rng.standard_normal((BATCH // 2, DIM), dtype=np.float32)
    near_pos = {int(r): i for i, r in enumerate(near)}

    reset_counts()
    ingest_s = 0.0
    for start, x in corpus_batches():
        for r in range(start, start + len(x)):
            i = near_pos.get(r)
            if i is not None:
                queries[i] = x[r - start] + 0.5 * rng.standard_normal(DIM, dtype=np.float32)
        docs = [Document(id=f"doc{start + i}", content=f"doc {(start + i) % 997}",
                         vector=x[i], metadata={"g": int(group_of(start + i))})
                for i in range(len(x))]
        t0 = time.perf_counter()
        db.batch_add_documents(docs)
        ingest_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    require(len(db.index) == N_ROWS and db.index.capacity == N_ROWS,
            f"index holds {len(db.index)} rows at capacity {db.index.capacity}")
    log(f"[flat] ingested {N_ROWS} documents in {ingest_s:.2f} s "
        f"({N_ROWS / ingest_s:.0f} docs/s, batches of {INGEST_BATCH}); capacity "
        f"{db.index.capacity}, {db.index.get_stats().memory_usage_mb:.0f} MB on the device")

    batch = db.vector_search_batch(queries, 10)
    single = [db.vector_search(SearchRequest(vector=queries[i].tolist(), limit=3))
              for i in range(4)]
    filt = Filter(must=[Condition("g", "eq", 3)])
    filtered = [db.vector_search(SearchRequest(vector=queries[i].tolist(), limit=10,
                                               filter=filt)) for i in range(4)]
    # delete 1000 documents, the current top hits first
    doomed = list(dict.fromkeys(int(p.id[3:]) for row in batch for p in row))[:1000]
    taken = set(doomed)
    doomed += [i for i in range(N_ROWS) if i not in taken][:1000 - len(doomed)]
    n_del = db.batch_delete_documents([f"doc{i}" for i in doomed])
    require(n_del == 1000, f"deleted {n_del} documents, wanted 1000")
    after = db.vector_search_batch(queries, 10)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[flat] searches done: batch B={BATCH} k=10, 4 x k=3, 4 x filtered k=10, "
        f"deleted 1000, batch again; kernel launches {launches}")
    for name in ("segmax4", "segmax2"):
        require(launches[name] > 0, f"the flat path never launched {name}")

    (o_vals, o_ids), (f_vals, f_ids) = oracle(corpus_batches(), queries, group_of)
    check_hits("batch k=10", batch, o_vals, o_ids, 10)
    check_hits("single k=3", single, o_vals[:4], o_ids[:4], 3)
    check_hits("filtered k=10", filtered, f_vals[:4], f_ids[:4], 10)
    require(all(int(p.id[3:]) % 10 == 3 for row in filtered for p in row),
            "a filtered result broke the filter")
    check_hits("after delete k=10", after, o_vals, o_ids, 10, exclude=frozenset(doomed))
    top1 = sum(int(batch[i][0].id[3:]) == int(near[i]) for i in range(BATCH // 2))
    log(f"[flat] all answers agree with the numpy oracle (f32 cosine over the "
        f"bf16-rounded corpus, tolerance {TOL}); near-document queries found their "
        f"document first {top1}/{BATCH // 2}")
    med = timed(lambda: db.vector_search_batch(queries, 10))
    log(f"[times] flat vector_search_batch B={BATCH} k=10 at {N_ROWS - 1000} documents: "
        f"median {med * 1e3:.3f} ms of 20 ({BATCH / med:.0f} queries/s); "
        f"ingest {N_ROWS / ingest_s:.0f} docs/s")
    flat_breakdown(db.index, queries, med)
    return {name: launches[name] for name in ("segmax4", "segmax2")}, db


def flat_breakdown(idx, queries, e2e_s):
    """Where a flat vector_search_batch call's time goes: the device span of
    scored_topk (B1 and phase 2; CUDA events), B1 alone on the index's own
    tensors, the index's search_batch on the host clock (plus upload,
    readback, hit building), and the planner and result building (the
    rest)."""
    from grape_vector_db_tpu_torch.index import flat
    from grape_vector_db_tpu_torch.ops import segmax
    from grape_vector_db_tpu_torch.ops.distance import prepare_queries, scored_topk

    qt = torch.from_numpy(queries).to(DEV)
    chunk = min(flat._SEARCH_CHUNK, idx.capacity)
    dev_ms = cuda_ms(lambda: scored_topk(qt, idx.vectors, idx.norms, idx.valid, 10,
                                         metric=idx.metric, chunk=chunk,
                                         mode=idx.search_mode), 20)
    qp = prepare_queries(qt, idx.metric)
    w = segmax.make_weight_plane(idx.norms, idx.valid, idx.metric)
    b1_ms = cuda_ms(lambda: segmax.segmax4_scores(qp, idx.vectors, w), 20)
    index_ms = timed(lambda: idx.search_batch(queries, 10)) * 1e3
    e2e_ms = e2e_s * 1e3
    log(f"[times] flat breakdown of vector_search_batch B={BATCH} k=10: end to end "
        f"{e2e_ms:.3f} ms; index.search_batch {index_ms:.3f} ms (median of 20); device "
        f"scored_topk span {dev_ms:.3f} ms (B1 {b1_ms:.3f} ms, phase 2 {dev_ms - b1_ms:.3f} ms); "
        f"upload, readback and hit building {index_ms - dev_ms:.3f} ms; planner and results "
        f"{e2e_ms - index_ms:.3f} ms; device busy share ~{dev_ms / e2e_ms:.2f}")


# -- the IVF family ---------------------------------------------------------------


class Clustered:
    """The 1M IVF corpus (bench.py:483-506): Gaussian centres plus 0.25 noise,
    made with numpy from SEED, with a query batch (half stored rows + 0.05
    noise, half fresh points of the cluster distribution) and the numpy
    oracle's f32 cosine scores of every query against every bf16-rounded
    row."""

    def __init__(self, rows: int):
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED + 2)
        centres = rng.standard_normal((IVF_CENTRES, DIM), dtype=np.float32)
        self.x = np.empty((rows, DIM), np.float32)
        for off in range(0, rows, INGEST_BATCH):
            cid = rng.integers(0, IVF_CENTRES, INGEST_BATCH)
            self.x[off:off + INGEST_BATCH] = centres[cid] + IVF_NOISE * rng.standard_normal(
                (INGEST_BATCH, DIM), dtype=np.float32)
        self.near = rng.choice(rows, BATCH // 2, replace=False)
        q = np.empty((BATCH, DIM), np.float32)
        q[:BATCH // 2] = self.x[self.near] + 0.05 * rng.standard_normal(
            (BATCH // 2, DIM), dtype=np.float32)
        q[BATCH // 2:] = (centres[rng.integers(0, IVF_CENTRES, BATCH // 2)]
                          + IVF_NOISE * rng.standard_normal((BATCH // 2, DIM), dtype=np.float32))
        self.queries = q
        self.qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        self.scores = np.empty((BATCH, rows), np.float32)
        for off in range(0, rows, 65536):
            xr = torch.from_numpy(self.x[off:off + 65536]).to(torch.bfloat16).float().numpy()
            self.scores[:, off:off + 65536] = (self.qn @ xr.T) / np.linalg.norm(xr, axis=1)[None, :]
        self.rows = rows
        log(f"[ivf] corpus {rows} x {DIM} ({IVF_CENTRES} centres + {IVF_NOISE} noise), "
            f"queries and oracle scores made in {time.perf_counter() - t0:.1f} s")


def to_rows(hits):
    """ScoredPoint lists or (id, score) lists -> lists of (row, score)."""
    out = []
    for row in hits:
        out.append([(int(h.id[3:]), h.score) if hasattr(h, "id") else (int(h[0][3:]), h[1])
                    for h in row])
    return out


def list_of_rows(idx, rows: int) -> np.ndarray:
    """[rows] list id of each document in the index's bookkeeping: -1 in the
    overflow region, -2 when absent (deleted)."""
    out = np.full(rows, -2, np.int64)
    for id_, (lst, _) in idx._id_to_cell.items():
        out[int(id_[3:])] = lst
    for id_ in idx._overflow._id_to_slot:
        out[int(id_[3:])] = -1
    return out


def probed_candidates(idx, corpus: Clustered, qsel, allowed=None):
    """Per query of ``qsel``: the candidate-row mask of the probe oracle (rows
    of the nprobe lists the port's own centroids choose, plus the overflow
    region, minus absent rows), or None for a query whose nprobe-th and next
    centroid scores lie within 1e-5 (a near tie of the list choice)."""
    cents = idx.centroids.float().cpu().numpy()
    row_list = list_of_rows(idx, corpus.rows)
    out = []
    for r in qsel:
        cs = corpus.qn[r] @ cents.T
        order = np.argsort(-cs)
        if cs[order[NPROBE - 1]] - cs[order[NPROBE]] < 1e-5:
            out.append(None)
            continue
        lut = np.zeros(idx.nlist + 2, bool)
        lut[order[:NPROBE] + 2] = True
        lut[1] = True                                   # the overflow region
        cand = lut[row_list + 2]
        if allowed is not None:
            cand &= allowed
        out.append(cand)
    return out


def top_of(scores: np.ndarray, cand: np.ndarray, k: int):
    s = np.where(cand, scores, -np.inf)
    top = np.argpartition(-s, k - 1)[:k]
    top = top[np.argsort(-s[top])]
    return [(int(i), float(s[i])) for i in top if np.isfinite(s[i])]


def check_exact(name, hits, corpus, qsel, cands, k):
    """Ids as sets against the oracle's top-k over each query's candidates
    (near-tie guard), scores within TOL. Returns (recall, queries checked)."""
    found = total = checked = 0
    for r, row, cand in zip(qsel, hits, cands):
        if cand is None:
            continue
        want = top_of(corpus.scores[r], cand, k)
        require(len(want) == k, f"{name}: oracle has fewer than {k} rows")
        got = dict(row)
        require(len(row) == k and len(got) == k, f"{name} q{r}: {len(row)} hits, duplicates?")
        ref = dict(want)
        kth = want[-1][1]
        for i in set(got) ^ set(ref):
            s = got.get(i, ref.get(i))
            require(abs(s - kth) <= TOL, f"{name} q{r}: id {i} (score {s}) differs from "
                    f"the oracle away from the k-th score {kth}")
        for i in set(got) & set(ref):
            require(abs(got[i] - ref[i]) <= TOL,
                    f"{name} q{r}: score of {i} {got[i]} vs oracle {ref[i]}")
        found += len(set(got) & set(ref))
        total += k
        checked += 1
    return found / max(total, 1), checked


def check_members(name, hits, corpus, qsel, cands, k):
    """For the quantized kinds, whose final ranking depends on which
    candidates the code scores keep: every returned id is a candidate and
    its score is the oracle's exact score for it within TOL. Returns
    (recall against the oracle's top-k over the candidates, queries checked)."""
    found = total = checked = 0
    for r, row, cand in zip(qsel, hits, cands):
        if cand is None:
            continue
        got = dict(row)
        require(len(row) == k and len(got) == k, f"{name} q{r}: {len(row)} hits, duplicates?")
        for i, s in got.items():
            require(bool(cand[i]), f"{name} q{r}: id {i} lies in no probed list or allowed row")
            require(abs(s - float(corpus.scores[r, i])) <= TOL,
                    f"{name} q{r}: score of {i} {s} vs exact {corpus.scores[r, i]}")
        want = {i for i, _ in top_of(corpus.scores[r], cand, k)}
        found += len(set(got) & want)
        total += k
        checked += 1
    return found / max(total, 1), checked


def recall_full(hits, corpus, alive, k=10):
    found = 0
    for r, row in enumerate(hits):
        want = {i for i, _ in top_of(corpus.scores[r], alive, k)}
        found += len({i for i, _ in row} & want)
    return found / (k * len(hits))


# the grouped probes: wrapper, the kernel's name in the profiler's events,
# the format code of the parent's gvdb_ivf_probe that --parent times where
# the parent has no grouped entry of the probe's name
GROUPED = {"ivf_probe_int8": ("ivf_probe_scores_int8", "int8_probe_kernel", 2),
           "ivf_probe_int4": ("ivf_probe_scores_int4", "int4_probe_kernel", 3)}


def grouped_details(name, qp, probe, data, w, nb, label):
    """B4 or B5 beyond its whole call: the grouping pass held against its
    plain version (the same bin starts, the same cells in each bin) and timed
    alone (its bound: read the ids, write the starts and the order; the
    library call: one stable torch.sort of the ids); the call's device time
    by kernel (torch.profiler); with --parent, the parent's kernel (B4: the
    per-cell kernel; B5: its grouped one) in turns with this tree's whole
    call (the parent's grouped entry ``gvdb_<name>`` where it has one, else
    format ``parent_fmt`` of its ``gvdb_ivf_probe``). Both sides of the
    turns call their C entry directly on buffers allocated once, so the
    wrapper's host work (allocation, dtype checks) is on neither. Returns
    (extra stats of the probe's entry, the grouping pass's entry)."""
    from grape_vector_db_tpu_torch.ops import ivf as tivf

    wrapper, kernel, parent_fmt = GROUPED[name]
    call_once = getattr(tivf, wrapper)
    n_lists = w.shape[0]
    order, start = tivf.group_cells(probe, n_lists)
    o_ref, s_ref = tivf.group_cells_ref(probe, n_lists)
    torch.cuda.synchronize()
    require(torch.equal(start, s_ref), f"ivf_group {label}: bin starts differ")
    bins = torch.where((probe >= 0) & (probe < n_lists), probe, n_lists).reshape(-1).long()
    key = bins[order.long()] * probe.numel() + order.long()
    require(torch.equal(torch.sort(key).values, bins[o_ref.long()] * probe.numel() + o_ref.long()),
            f"ivf_group {label}: a bin holds other cells than the plain version's")
    # the profiler can drop events, never add them: the largest of three
    g_ms = max(sum(x for key_, x in device_ms(lambda: tivf.group_cells(probe, n_lists)).items()
                   if "group_kernel" in key_) for _ in range(3))
    g_plain = cuda_ms(lambda: tivf.group_cells_ref(probe, n_lists), 5)
    flat = probe.reshape(-1)
    g_lib = cuda_ms(lambda: torch.sort(flat, stable=True), 10)
    group = {"max_abs_err": 0.0, "ms": g_ms, "plain_ms": g_plain,
             **bound(probe.numel() * 8 + (n_lists + 2) * 4, 0.0), "library_ms": g_lib}
    splits = []
    for _ in range(3):
        call = device_ms(lambda: call_once(qp, probe, data, w, nb))
        splits.append({"group_kernel": sum(x for k_, x in call.items() if "group_kernel" in k_),
                       "probe_kernel": sum(x for k_, x in call.items() if kernel in k_)})
    split = max(splits, key=lambda x: sum(x.values()))
    log(f"[times] {name} {label}: device time of the call by kernel: grouping pass "
        f"{split['group_kernel']:.4f} ms, kernel {split['probe_kernel']:.4f} ms; the grouping "
        f"pass alone {g_ms:.4f} ms (plain {g_plain:.4f} ms, torch.sort of the ids {g_lib:.4f} "
        f"ms; bound {group['bound_ms']:.5f} ms); {len(torch.unique(probe))} lists serve "
        f"{probe.numel()} cells")
    extra = {"device_split_ms": split}
    if PARENT:
        b, d = qp.shape
        p_, c = probe.shape[1], w.shape[1]
        out = torch.empty((b, p_, c), dtype=torch.float32, device=qp.device)
        lib = parent_lib("ivf_probe")
        qc, pc, nbc = qp.contiguous(), probe.contiguous(), nb.contiguous()
        stream = torch.cuda.current_stream().cuda_stream
        grouped = getattr(lib, f"gvdb_{name}", None)
        if grouped is not None:
            words = next(getattr(lib, e) for e in PARENT_SCRATCH_WORDS if hasattr(lib, e))
            scratch = torch.empty(words(b * p_, n_lists, b, d), dtype=torch.int32,
                                  device=qp.device)
            which = f"grouped kernel (gvdb_{name})"

            def parent():
                rc = grouped(0, qc.data_ptr(), pc.data_ptr(), data.data_ptr(), w.data_ptr(),
                             nbc.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, p_, n_lists,
                             c, d, stream)
                require(rc == 0, f"the parent's gvdb_{name} failed: {rc}")
        else:
            which = f"per-cell kernel (gvdb_ivf_probe format {parent_fmt})"

            def parent():
                rc = lib.gvdb_ivf_probe(parent_fmt, 0, qc.data_ptr(), pc.data_ptr(),
                                        data.data_ptr(), w.data_ptr(), nbc.data_ptr(),
                                        out.data_ptr(), b, p_, n_lists, c, d, stream)
                require(rc == 0, f"the parent's gvdb_ivf_probe format {parent_fmt} failed: {rc}")

        mine = getattr(tivf.build_kernels(), f"gvdb_{name}")
        out_c = torch.empty_like(out)
        scratch_c = torch.empty(tivf.build_kernels().gvdb_ivf_scratch_words(b * p_, n_lists, b, d),
                                dtype=torch.int32, device=qp.device)

        def change():
            rc = mine(0, qc.data_ptr(), pc.data_ptr(), data.data_ptr(), w.data_ptr(),
                      nbc.data_ptr(), out_c.data_ptr(), scratch_c.data_ptr(), b, p_, n_lists, c,
                      d, stream)
            require(rc == 0, f"gvdb_{name} failed: {rc}")

        out.fill_(float("nan"))
        parent()
        change()
        torch.cuda.synchronize()
        new = call_once(qp, probe, data, w, nb)
        require(torch.equal(out_c, new), f"{name} {label}: the C entry and the wrapper differ")
        inv = new == -1e9
        require(torch.equal(out == -1e9, inv), f"{name} {label}: the parent's -1e9 differ")
        diff = (out - new)[~inv].abs().max().item()
        require(diff <= TOL, f"{name} {label}: the parent's scores differ by {diff}")
        (n1, n2), (o1, o2) = in_turns(change, parent, 20, 20)
        extra["parent_ms"] = [o1, n1, n2, o2]
        log(f"[times] {name} {label} against the parent's {which}, in turns (parent, change, "
            f"change, parent): {o1:.4f} / {n1:.4f} / {n2:.4f} / {o2:.4f} ms (the two agree "
            f"within {diff:.3g})")
    else:
        log(f"[times] {name} {label}: the parent's kernel not timed (no --parent)")
    return extra, group


# the probe kernel -> (its plain version's name in ops/ivf, the library
# composition's first calls)
PROBE_LIBRARY = {
    "ivf_probe": ("ivf_probe_scores_ref", "the probed lists' rows gathered (bf16)"),
    "ivf_probe_int8": ("ivf_probe_scores_int8_ref",
                       "the probed lists' codes gathered, .to(bf16)"),
    "ivf_probe_int4": ("ivf_probe_scores_int4_ref",
                       "the probed lists' codes gathered, the nibbles unpacked (two masks, "
                       "a shift, cat) to bf16 levels, minus 8"),
}


def probe_library_ms(name, qp, probe, data, w, nb):
    """The nearest library composition of B3, B4 or B5, timed on the same
    inputs: the probed lists' rows gathered (B4: .to(bf16); B5: the nibbles
    unpacked to bf16 levels first), torch.bmm with q' (f32 out), times the
    weights, where (plus the masks' index arithmetic), in query chunks of at
    most 2^30 gathered elements. Returns (ms, a description)."""
    from grape_vector_db_tpu_torch.ops import ivf as tivf

    ref_name, first = PROBE_LIBRARY[name]
    n_lists, cap = w.shape
    b, d = qp.shape
    p_ = probe.shape[1]
    pr = probe.long()
    known = (pr >= 0) & (pr < n_lists)
    pr = torch.where(known, pr, 0)
    qb = qp.to(torch.bfloat16)
    lim = torch.clamp(torch.clamp(nb.long(), min=0) * 64, max=cap)
    pos = torch.arange(cap, device=w.device)
    out = torch.empty((b, p_, cap), dtype=torch.float32, device=w.device)
    step = max(1, (1 << 30) // (p_ * cap * d))

    def rows_of(sel):
        rows = data[sel]                                   # [bs, P, C, width]
        if name == "ivf_probe_int4":
            rows = torch.cat([rows & 15, (rows >> 4) & 15], dim=-1).to(torch.bfloat16) - 8
        return rows.to(torch.bfloat16)

    def call():
        for b0 in range(0, b, step):
            sel = pr[b0:b0 + step]
            rows = rows_of(sel)
            bs = rows.shape[0]
            dots = torch.bmm(rows.reshape(bs, p_ * cap, d), qb[b0:b0 + step, :, None],
                             out_dtype=torch.float32).reshape(bs, p_, cap)
            wr = w[sel]
            live = ((wr != 0) & (pos < lim[sel][:, :, None]) & known[b0:b0 + step, :, None])
            out[b0:b0 + step] = torch.where(live, dots * wr, -1e9)
        return out

    got = call().clone()
    torch.cuda.synchronize()
    want = getattr(tivf, ref_name)(qp, probe, data, w, nb)
    inv = want == -1e9
    require(torch.equal(got == -1e9, inv), f"{name}: the library composition's -1e9 differ")
    require((got - want)[~inv].abs().max().item() <= TOL,
            f"{name}: the library composition disagrees with the plain version")
    return cuda_ms(call, 5), f"composition: {first}, torch.bmm out_dtype=f32, multiply, where"


def probe_main_shapes(kind, idx, corpus):
    """The path's probe kernel against its plain version at the main path's
    shapes, taken from the real index after optimize(); times both in turns
    and computes the bound."""
    from grape_vector_db_tpu_torch.ops import ivf as tivf
    from grape_vector_db_tpu_torch.ops.distance import prepare_queries

    name = IVF_KERNEL[kind]
    if kind == "ivf":
        kern, plain, data, w = tivf.ivf_probe_scores, tivf.ivf_probe_scores_ref, idx.vecs, idx.recip
    elif kind == "ivf_int8":
        kern, plain, data, w = (tivf.ivf_probe_scores_int8, tivf.ivf_probe_scores_int8_ref,
                                idx.codes, idx.factor)
    else:
        kern, plain, data, w = (tivf.ivf_probe_scores_int4, tivf.ivf_probe_scores_int4_ref,
                                idx.codes, idx.factor)
    qp = prepare_queries(torch.from_numpy(corpus.queries).to(DEV), "cosine")
    _, probe = torch.topk(qp @ idx.centroids.T, NPROBE, dim=1)
    probe = probe.to(torch.int32)
    nb = idx._nblocks()
    got = kern(qp, probe, data, w, nb)
    torch.cuda.synchronize()
    want = plain(qp, probe, data, w, nb)
    inv = want == -1e9
    require(torch.equal(got == -1e9, inv), f"{name}: -1e9 positions differ")
    err = (got - want)[~inv].abs().max().item()
    require(err <= TOL, f"{name}: max |score diff| {err} > {TOL}")
    (k1, k2), (p1, p2) = in_turns(lambda: kern(qp, probe, data, w, nb),
                                  lambda: plain(qp, probe, data, w, nb))
    n_lists, cap = w.shape
    lim = torch.clamp(nb.long() * 64, max=cap)
    live = (w != 0) & (torch.arange(cap, device=w.device)[None, :] < lim[:, None])
    rows_per_list = live.sum(dim=1)
    row_bytes = data.shape[2] * data.element_size() + 4      # the row and its weight
    per_cell = int(rows_per_list[probe.long()].sum()) * row_bytes
    unique = int(rows_per_list[torch.unique(probe.long())].sum()) * row_bytes
    other = (BATCH * DIM * 4 + probe.numel() * 4 + n_lists * 4
             + BATCH * NPROBE * cap * 4)                       # q, probe, nblocks, output
    ops = 2.0 * int(rows_per_list[probe.long()].sum()) * DIM
    b = bound(min(per_cell, unique) + other, ops)
    log(f"[kernels] {name} [{BATCH},{DIM}] x probe [{BATCH},{NPROBE}] over [{n_lists},{cap},"
        f"{data.shape[2]}] {data.dtype} (index after optimize): max_abs_err {err:.3g}, "
        f"-1e9 positions equal")
    log(f"[times] {name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; "
        f"reads per cell {per_cell / 1e9:.3f} GB, each probed list once {unique / 1e9:.3f} GB "
        f"({len(torch.unique(probe))} lists); bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    stats = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, **b}
    stats["library_ms"], stats["library"] = probe_library_ms(name, qp, probe, data, w, nb)
    log(f"[times] {name}: library {stats['library']}: {stats['library_ms']:.4f} ms")
    if name in GROUPED:
        extra, stats["group"] = grouped_details(name, qp, probe, data, w, nb, f"D={DIM}")
        stats.update(extra)
    return stats


def search_breakdown(kind, idx, corpus, e2e_s, probe_ms):
    """Where a vector_search_batch call's time goes: the device span of the
    index's top-k (centroid scores, probe, selection; CUDA events), the
    index's search_batch on the host clock (plus upload, readback, hit
    building), and the planner and result building (the rest)."""
    qt = torch.from_numpy(corpus.queries).to(DEV)
    dev_ms = cuda_ms(lambda: idx._main_topk(qt, 10, None), 20)
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        idx.search_batch(corpus.queries, 10)
        times.append(time.perf_counter() - t0)
    index_ms = statistics.median(times) * 1e3
    e2e_ms = e2e_s * 1e3
    log(f"[times] {kind} breakdown of vector_search_batch B={BATCH}: end to end {e2e_ms:.3f} ms; "
        f"index.search_batch {index_ms:.3f} ms (median of 20); device top-k span "
        f"{dev_ms:.3f} ms (probe kernel {probe_ms:.3f} ms); upload, readback and hit building "
        f"{index_ms - dev_ms:.3f} ms; planner and results {e2e_ms - index_ms:.3f} ms; "
        f"device busy share ~{dev_ms / e2e_ms:.2f}")


def ivf_path(kind: str, corpus: Clustered, nlist: int):
    from grape_vector_db_tpu_torch import (Condition, Document, Filter, SearchRequest,
                                           VectorDatabase, VectorDbConfig)

    rows = corpus.rows
    cfg = VectorDbConfig(vector_dimension=DIM)
    cfg.index.kind = kind
    cfg.index.nlist = nlist
    cfg.index.nprobe = NPROBE
    db = VectorDatabase(config=cfg, device=DEV)
    idx = db.index
    quant = kind != "ivf"
    check = check_members if quant else check_exact
    group = np.arange(rows) % 10
    everyone = list(range(BATCH))
    tag = f"[{kind}]"
    log(f"{tag} VectorDatabase: {rows} rows, nlist {nlist}, nprobe {idx.nprobe}, metric "
        f"{idx.metric}, storage {idx.storage_dtype}"
        + (f", rescore {idx.rescore}, keep_bf16 {idx.keep_bf16}" if quant else ""))

    reset_counts()
    ingest_s = 0.0
    for start in range(0, rows, INGEST_BATCH):
        x = corpus.x[start:start + INGEST_BATCH]
        docs = [Document(id=f"doc{start + i}", content=f"doc {(start + i) % 997}",
                         vector=x[i], metadata={"g": int(group[start + i])})
                for i in range(len(x))]
        t0 = time.perf_counter()
        db.batch_add_documents(docs)
        ingest_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    require(len(idx) == rows, f"{kind}: index holds {len(idx)} rows")
    n_over = len(idx._overflow)
    before = to_rows(db.vector_search_batch(corpus.queries, 10))
    before_cands = probed_candidates(idx, corpus, everyone)
    t0 = time.perf_counter()
    db.optimize()
    torch.cuda.synchronize()
    optimize_s = time.perf_counter() - t0
    log(f"{tag} ingested {rows} in {ingest_s:.2f} s ({rows / ingest_s:.0f} docs/s); "
        f"{n_over} rows in the overflow region before optimize(); optimize() "
        f"{optimize_s:.2f} s: list_cap {idx.list_cap}, overflow {len(idx._overflow)}, "
        f"{idx.get_stats().memory_usage_mb:.0f} MB")

    batch = to_rows(db.vector_search_batch(corpus.queries, 10))
    single = [to_rows([db.vector_search(SearchRequest(vector=corpus.queries[i].tolist(),
                                                      limit=3))])[0] for i in range(4)]
    f90 = [to_rows([db.vector_search(SearchRequest(
        vector=corpus.queries[i].tolist(), limit=10,
        filter=Filter(must=[Condition("g", "lt", 9)])))])[0] for i in range(4)]
    f10 = [to_rows([db.vector_search(SearchRequest(
        vector=corpus.queries[i].tolist(), limit=10,
        filter=Filter(must=[Condition("g", "eq", 3)])))])[0] for i in range(4)]
    compact_used = idx._compact_cache is not None
    allowed_ids = {f"doc{r}" for r in np.flatnonzero(group == 3)}
    idx.compact_max_bytes = 0                      # force the streaming tier
    with idx.locked():
        mask = idx.compile_mask(allowed_ids)
        stream = to_rows(idx.search_batch(corpus.queries, 10, mask=mask, exhaustive=True))
    del idx.compact_max_bytes
    post_cands = probed_candidates(idx, corpus, everyone)
    # delete 1000 documents, the current top hits first
    doomed = list(dict.fromkeys(i for row in batch for i, _ in row))[:1000]
    taken = set(doomed)
    doomed += [i for i in range(rows) if i not in taken][:1000 - len(doomed)]
    n_del = db.batch_delete_documents([f"doc{i}" for i in doomed])
    require(n_del == 1000, f"{kind}: deleted {n_del} documents, wanted 1000")
    after = to_rows(db.vector_search_batch(corpus.queries, 10))
    torch.cuda.synchronize()
    launches = read_counts()
    kname = IVF_KERNEL[kind]
    log(f"{tag} searches done: batch B={BATCH} before and after optimize, 4 x k=3, 4 x "
        f"filtered at 90% and 10%, the streaming tier, deleted 1000, batch again; "
        f"kernel launches {launches}")
    require(launches[kname] > 0, f"the {kind} path never launched {kname}")
    if kname in GROUPED:
        require(launches["ivf_group"] == launches[kname],
                f"the {kind} path's probes and grouping passes differ in number")
    require(compact_used, f"{kind}: the 10% filter did not take the compact tier")

    alive = np.ones(rows, bool)
    rec_b, n_b = check("before optimize k=10", before, corpus, everyone, before_cands, 10)
    rec, n_ok = check("batch k=10", batch, corpus, everyone, post_cands, 10)
    check("single k=3", single, corpus, range(4), post_cands[:4], 3)
    rec90, _ = check("filtered 90% k=10", f90, corpus, range(4),
                     [None if c is None else c & (group < 9) for c in post_cands[:4]], 10)
    full10 = [group == 3] * 4
    check_exact("filtered 10% (compact tier) k=10", f10, corpus, range(4), full10, 10)
    if quant:
        # the streaming tier scores the codes (no rescore): its ids must be
        # allowed; its recall against the exact masked oracle is reported
        rec_s = recall_full(stream, corpus, group == 3)
        require(all(group[i] == 3 for row in stream for i, _ in row) and
                all(len(row) == 10 for row in stream), f"{kind}: streaming tier broke the filter")
    else:
        rec_s, _ = check_exact("streaming tier k=10", stream, corpus, everyone,
                               [group == 3] * BATCH, 10)
    gone = set(doomed)
    alive[list(gone)] = False
    require(not any(i in gone for row in after for i, _ in row),
            f"{kind}: a deleted id came back")
    after_cands = probed_candidates(idx, corpus, everyone)
    rec_a, _ = check("after delete k=10", after, corpus, everyone, after_cands, 10)
    skipped = sum(c is None for c in post_cands)
    top1 = sum(batch[i][0][0] == int(corpus.near[i]) for i in range(BATCH // 2))
    log(f"{tag} answers agree with the numpy oracles ({'ids in probed lists, exact scores' if quant else 'exact over the probed lists'}"
        f", tolerance {TOL}): {n_ok} of {BATCH} queries checked ({skipped} left out for a "
        f"near tie of the list choice); recall@10 against the probed-lists oracle "
        f"{rec:.4f} (before optimize {rec_b:.4f}, after delete {rec_a:.4f}, 90% filter "
        f"{rec90:.4f}); streaming tier recall@10 against the exact masked oracle {rec_s:.4f}; "
        f"near-document queries found their document first {top1}/{BATCH // 2}")
    log(f"{tag} recall@10 at nprobe {NPROBE} against the full flat oracle: "
        f"{recall_full(batch, corpus, np.ones(rows, bool)):.4f}")

    med = timed(lambda: db.vector_search_batch(corpus.queries, 10))
    log(f"[times] {kind} vector_search_batch B={BATCH} k=10 at {rows - 1000} documents: "
        f"median {med * 1e3:.3f} ms of 20 ({BATCH / med:.0f} queries/s); ingest "
        f"{rows / ingest_s:.0f} docs/s; optimize {optimize_s:.2f} s")
    stats = probe_main_shapes(kind, idx, corpus)
    search_breakdown(kind, idx, corpus, med, stats["ms"])
    # what the sharded twin of this kind is held to (sharded_ivf_part, which
    # closes the database)
    handoff = {"db": db, "centroids": idx.centroids.clone(), "list_cap": idx.list_cap,
               "doomed": doomed, "after": after}
    return launches, stats, handoff


# -- the binary kind ----------------------------------------------------------------


def bf16_rows(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def exact_scores(qn: np.ndarray, x: np.ndarray, rows) -> np.ndarray:
    """f32 cosine of each unit query against the bf16-rounded rows ``rows``."""
    xr = bf16_rows(x[rows])
    return (xr @ qn.T).T / np.linalg.norm(xr, axis=1)[None, :]


def prescan_keys(kind: str, queries: np.ndarray, x: np.ndarray, alive: np.ndarray):
    """Per query, the stage-1 score of every row on the card, computed from
    the rows' signs with plain f32 products (not the port's packed codes):
    ``"hamming"`` gives int64 keys d << 32 | row (smaller first, ties on the
    lower row, as the index selects); ``"asym"`` gives bf16(q_unit) . sign(x)
    (larger first). Rows not ``alive`` get the worst key."""
    dev = torch.device(DEV)
    qt = torch.from_numpy(queries).to(dev)
    if kind == "hamming":
        qs = torch.where(qt > 0, 1.0, -1.0)
    else:
        qs = torch.nn.functional.normalize(qt, dim=1).to(torch.bfloat16).float()
    out = []
    alive_t = torch.from_numpy(alive).to(dev)
    for off in range(0, len(x), 65536):
        xs = torch.where(torch.from_numpy(x[off:off + 65536]).to(dev) > 0, 1.0, -1.0)
        dots = qs @ xs.T
        ok = alive_t[off:off + 65536][None, :]
        if kind == "hamming":
            d = ((x.shape[1] - dots) * 0.5).round().to(torch.int64)
            rows = torch.arange(off, off + xs.shape[0], device=dev)[None, :]
            out.append(torch.where(ok, (d << 32) | rows, torch.iinfo(torch.int64).max))
        else:
            out.append(torch.where(ok, dots, float("-inf")))
    return torch.cat(out, dim=1)


def check_candidates(name, hits, keys, kind: str, r: int, tol=1e-3):
    """Every returned row lies among the top-r of the prescan oracle: for
    Hamming exactly (integers, the same tie rule), for the asymmetric
    prescan within ``tol`` of the r-th score (f32 sums in another order)."""
    if kind == "hamming":
        kth = torch.topk(keys, r, dim=1, largest=False).values[:, -1].cpu().numpy()
    else:
        kth = torch.topk(keys, r, dim=1).values[:, -1].cpu().numpy()
    k_np = keys.cpu().numpy()
    for qi, row in enumerate(hits):
        for i, _ in row:
            ok = k_np[qi, i] <= kth[qi] if kind == "hamming" else k_np[qi, i] >= kth[qi] - tol
            require(bool(ok), f"{name} q{qi}: row {i} is not among the prescan's top {r}")


def check_exact_scores(name, hits, qn, x, tol=TOL):
    for qi, row in enumerate(hits):
        rows = [i for i, _ in row]
        want = exact_scores(qn[qi:qi + 1], x, rows)[0]
        for (i, s), w_ in zip(row, want):
            require(abs(s - float(w_)) <= tol, f"{name} q{qi}: score of {i} {s} vs exact {w_}")


def recall_at(hits, o_ids, k=10, exclude=frozenset()):
    found = 0
    for row, ids in zip(hits, o_ids):
        want = [int(i) for i in ids if int(i) not in exclude][:k]
        found += len({i for i, _ in row} & set(want))
    return found / (k * len(hits))


def numpy_hamming_top(x: np.ndarray, queries: np.ndarray, k: int, alive: np.ndarray):
    """numpy xor/popcount oracle: per query the k smallest (distance, row)."""
    packed = np.packbits(x > 0, axis=1, bitorder="little")          # [N, D/8]
    table = np.array([bin(v).count("1") for v in range(256)], np.uint8)
    out = []
    for q in queries:
        qp = np.packbits(q > 0, bitorder="little")
        d = table[packed ^ qp].sum(axis=1, dtype=np.int64)
        d = np.where(alive, d, 2**40)
        top = np.lexsort((np.arange(len(d)), d))[:k]
        out.append([(int(i), int(d[i])) for i in top])
    return out


def binary_path():
    """The binary kind at BINARY_ROWS x 768 of the flat path's Gaussian corpus."""
    from grape_vector_db_tpu_torch import (Condition, Document, Filter, SearchRequest,
                                           VectorDatabase, VectorDbConfig)
    from grape_vector_db_tpu_torch.index import BinaryDeviceIndex
    from grape_vector_db_tpu_torch.ops.hamming import hamming_topk, pack_bits

    rows = BINARY_ROWS
    batches = rows // INGEST_BATCH
    x = np.concatenate([b for _, b in itertools.islice(corpus_batches(), batches)])
    group = np.arange(rows) % 10
    rng = np.random.default_rng(SEED + 5)
    near = rng.choice(rows, BATCH // 2, replace=False)
    queries = np.concatenate([
        x[near] + 0.5 * rng.standard_normal((BATCH // 2, DIM), dtype=np.float32),
        rng.standard_normal((BATCH // 2, DIM), dtype=np.float32)])
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    cfg = VectorDbConfig(vector_dimension=DIM)
    cfg.index.kind = "binary"
    db = VectorDatabase(config=cfg, device=DEV)
    idx = db.index
    log(f"[binary] VectorDatabase: {rows} rows, prescan {idx.prescan}, hamming_impl "
        f"{idx.hamming_impl}, rescore_ratio {idx.rescore_ratio}, max_rescore {idx.max_rescore}")

    reset_counts()
    ingest_s = 0.0
    for start in range(0, rows, INGEST_BATCH):
        xb = x[start:start + INGEST_BATCH]
        docs = [Document(id=f"doc{start + i}", content=f"doc {(start + i) % 997}",
                         vector=xb[i], metadata={"g": int(group[start + i])})
                for i in range(len(xb))]
        t0 = time.perf_counter()
        db.batch_add_documents(docs)
        ingest_s += time.perf_counter() - t0
    pop = BinaryDeviceIndex(DIM, hamming_impl="popcount", prescan="hamming", device=DEV)
    codes_only = BinaryDeviceIndex(DIM, keep_vectors=False, prescan="hamming", device=DEV)
    t0 = time.perf_counter()
    for start in range(0, rows, INGEST_BATCH):
        ids = [f"doc{i}" for i in range(start, min(start + INGEST_BATCH, rows))]
        pop.add_batch(ids, x[start:start + INGEST_BATCH])
        codes_only.add_batch(ids, x[start:start + INGEST_BATCH])
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    require(len(idx) == len(pop) == len(codes_only) == rows, "binary: row counts differ")

    r = idx._rescore_count(10)
    asym_hits = to_rows(db.vector_search_batch(queries, 10))
    pop_hits = to_rows(pop.search_batch(queries, 10))
    ham_only = to_rows(pop.hamming_only_topk(queries, 10))
    codes_hits = to_rows(codes_only.search_batch(queries, 10))
    filt = Filter(must=[Condition("g", "eq", 3)])
    filtered = [to_rows([db.vector_search(SearchRequest(vector=queries[i].tolist(), limit=10,
                                                        filter=filt))])[0] for i in range(4)]
    doomed = list(dict.fromkeys(i for row in asym_hits + pop_hits for i, _ in row))[:1000]
    taken = set(doomed)
    doomed += [i for i in range(rows) if i not in taken][:1000 - len(doomed)]
    n_del = db.batch_delete_documents([f"doc{i}" for i in doomed])
    require(n_del == 1000 and pop.remove_batch([f"doc{i}" for i in doomed]) == 1000,
            "binary: delete count")
    after = to_rows(db.vector_search_batch(queries, 10))
    pop_after = to_rows(pop.search_batch(queries, 10))
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[binary] ingested {rows} through VectorDatabase in {ingest_s:.2f} s "
        f"({rows / ingest_s:.0f} docs/s); the popcount and codes-only indexes by add_batch "
        f"in {direct_s:.2f} s; searches done (B={BATCH} k=10: asym two-stage, popcount "
        f"two-stage, Hamming-only, codes-only; 4 x filtered 10%; deleted 1000, both "
        f"two-stage again); kernel launches {launches}")
    require(launches["hamming"] > 0, "the binary popcount path never launched hamming")
    require(launches["asym"] > 0, "the binary asym path never launched the asym kernel")

    # oracles
    (o_vals, o_ids), (f_vals, f_ids) = oracle(itertools.islice(corpus_batches(), batches),
                                              queries, lambda rr: rr % 10)
    alive = np.ones(rows, bool)
    k_asym = prescan_keys("asym", queries, x, alive)
    check_candidates("asym two-stage", asym_hits, k_asym, "asym", r)
    check_exact_scores("asym two-stage", asym_hits, qn, x)
    k_ham = prescan_keys("hamming", queries, x, alive)
    check_candidates("popcount two-stage", pop_hits, k_ham, "hamming", pop._rescore_count(10))
    check_exact_scores("popcount two-stage", pop_hits, qn, x)
    # Hamming-only: the ids of the prescan oracle's top 10, similarity 1 - d/D
    top10 = torch.topk(k_ham, 10, dim=1, largest=False).values.cpu().numpy()
    for qi, row in enumerate(ham_only):
        want = [(int(kk & 0xFFFFFFFF), 1.0 - float(kk >> 32) / DIM) for kk in top10[qi]]
        require(row == want, f"hamming-only q{qi}: {row[:3]} vs oracle {want[:3]}")
    require([[i for i, _ in row] for row in codes_hits] == [[i for i, _ in row] for row in ham_only]
            and all(abs(a[1] - b[1]) <= 1e-6 for ra, rb in zip(codes_hits, ham_only)
                    for a, b in zip(ra, rb)),
            "codes-only (mxu) and Hamming-only (popcount) differ")
    for qi, want in enumerate(numpy_hamming_top(x, queries[:HAMMING_CHECK_QUERIES], 10, alive)):
        require([(i, 1.0 - dd / DIM) for i, dd in want] == ham_only[qi],
                f"hamming-only q{qi} differs from the numpy xor/popcount oracle")
    del k_ham
    g3 = group == 3
    k_f = prescan_keys("asym", queries[:4], x, g3)
    check_candidates("filtered 10%", filtered, k_f, "asym", r)
    check_exact_scores("filtered 10%", filtered, qn[:4], x)
    require(all(i % 10 == 3 for row in filtered for i, _ in row) and
            all(len(row) == 10 for row in filtered), "binary: a filtered result broke the filter")
    gone = frozenset(doomed)
    alive[list(gone)] = False
    for name, hits in (("asym after delete", after), ("popcount after delete", pop_after)):
        require(not any(i in gone for row in hits for i, _ in row),
                f"{name}: a deleted id came back")
        check_exact_scores(name, hits, qn, x)
    check_candidates("asym after delete", after, prescan_keys("asym", queries, x, alive),
                     "asym", idx._rescore_count(10))
    check_candidates("popcount after delete", pop_after,
                     prescan_keys("hamming", queries, x, alive), "hamming",
                     pop._rescore_count(10))
    log(f"[binary] answers agree with the oracles: every two-stage id lies among its "
        f"prescan's top {r} (the asym prescan within 1e-3 of the {r}-th score) with its exact "
        f"score (tolerance {TOL}); Hamming-only equals the sign-product oracle on {BATCH} "
        f"queries and numpy's xor/popcount on {HAMMING_CHECK_QUERIES}; codes-only (mxu) "
        f"equals Hamming-only (popcount); the filter holds; deleted ids never return")
    log(f"[binary] recall@10 against the flat oracle: asym two-stage "
        f"{recall_at(asym_hits, o_ids):.4f}, popcount Hamming two-stage "
        f"{recall_at(pop_hits, o_ids):.4f}, Hamming-only {recall_at(ham_only, o_ids):.4f}; "
        f"filtered 10% {recall_at(filtered, f_ids):.4f}; after delete "
        f"{recall_at(after, o_ids, exclude=gone):.4f} / {recall_at(pop_after, o_ids, exclude=gone):.4f}")

    med = timed(lambda: db.vector_search_batch(queries, 10))
    med_pop = timed(lambda: pop.search_batch(queries, 10))
    med_ham = timed(lambda: pop.hamming_only_topk(queries, 10))
    qt = torch.from_numpy(queries).to(DEV)
    codes_t = pop.codes
    qcodes = pack_bits(qt, pop.threshold)
    dev_ms = cuda_ms(lambda: hamming_topk(qcodes, codes_t, pop.valid, k=pop._rescore_count(10),
                                          chunk=pop._scan_chunk(), impl="popcount"), 10)
    log(f"[times] binary vector_search_batch B={BATCH} k=10 at {rows - 1000} documents "
        f"(asym, mxu): median {med * 1e3:.3f} ms of 20 ({BATCH / med:.0f} queries/s); "
        f"popcount two-stage search_batch {med_pop * 1e3:.3f} ms; Hamming-only "
        f"{med_ham * 1e3:.3f} ms; the popcount prescan's device span "
        f"({-(-pop.capacity // pop._scan_chunk())} B6 chunks + selection, "
        f"r={pop._rescore_count(10)}) {dev_ms:.3f} ms; ingest "
        f"{rows / ingest_s:.0f} docs/s")
    db.close()
    return launches["hamming"], launches["asym"]


# -- the kernel-free kinds at SMALL_ROWS rows ------------------------------------------


class SmallCorpus:
    """One corpus of the kernel-free kinds: rows, a query batch (half stored
    rows plus noise, half fresh points), and the oracle's f32 cosine of every
    query against every bf16-rounded row."""

    def __init__(self, name: str, x: np.ndarray, queries: np.ndarray):
        self.name, self.x, self.queries, self.rows = name, x, queries, len(x)
        self.qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        self.scores = np.empty((len(queries), len(x)), np.float32)
        for off in range(0, len(x), 65536):
            self.scores[:, off:off + 65536] = exact_scores(self.qn, x, slice(off, off + 65536))
        self.top = np.argpartition(-self.scores, 9, axis=1)[:, :10]


def small_corpora():
    rng = np.random.default_rng(SEED + 9)
    n = SMALL_ROWS
    gauss = np.concatenate([b for _, b in itertools.islice(corpus_batches(),
                                                           n // INGEST_BATCH)])
    near = rng.choice(n, BATCH // 2, replace=False)
    gq = np.concatenate([gauss[near] + 0.5 * rng.standard_normal((BATCH // 2, DIM),
                                                                 dtype=np.float32),
                         rng.standard_normal((BATCH // 2, DIM), dtype=np.float32)])
    clustered = Clustered(n)
    basis = np.linalg.qr(rng.standard_normal((DIM, LOWRANK_RANK)))[0].astype(np.float32)
    centres = rng.standard_normal((IVF_CENTRES, LOWRANK_RANK), dtype=np.float32)

    def low_rank(m, cid):
        z = centres[cid] + LOWRANK_SPREAD * rng.standard_normal((m, LOWRANK_RANK),
                                                                dtype=np.float32)
        return z @ basis.T + LOWRANK_NOISE * rng.standard_normal((m, DIM), dtype=np.float32)

    low = np.concatenate([low_rank(INGEST_BATCH, rng.integers(0, IVF_CENTRES, INGEST_BATCH))
                          for _ in range(n // INGEST_BATCH)])
    lnear = rng.choice(n, BATCH // 2, replace=False)
    lq = np.concatenate([low[lnear] + LOWRANK_NOISE * rng.standard_normal(
        (BATCH // 2, DIM), dtype=np.float32),
        low_rank(BATCH // 2, rng.integers(0, IVF_CENTRES, BATCH // 2))])
    return (SmallCorpus("gaussian", gauss, gq),
            SmallCorpus("clustered", clustered.x, clustered.queries),
            SmallCorpus("low-rank", low.astype(np.float32), lq.astype(np.float32)))


def quant_oracle(kind: str, idx, corpus: SmallCorpus):
    """(candidate check, score of (query, row)) of the kind's own ranking, from
    numpy over the index's planes read back:
    - int8 / pq: the prescan's scores, whose top r hold every returned row,
      and the exact cosine (the rescore is exact);
    - ivf_pq: the rows of the probed lists (and the overflow region), and the
      resident plane's score (bf16: exact; int8: bf16 query x dequantized
      row; none: ADC over the decoded row);
    - the projected kinds: the probed lists in the projected space, and the
      cosine of the projected query against the bf16 projected row."""
    qn, x = corpus.qn, corpus.x
    if kind == "int8":
        codes = idx.codes.cpu().numpy().astype(np.float32)
        factor = (idx.scales / torch.clamp(idx.norms, min=1e-12)).cpu().numpy()
        qs = np.abs(qn).max(axis=1, keepdims=True) * np.float32(1.0 / 127.0)
        qi = np.clip(np.round(qn / qs), -127, 127)
        pre = (qi @ codes.T) * factor[None, :] * qs
        return ("prescan", pre, idx._rescore_count(10)), None
    if kind == "pq":
        cb = idx.codebooks.cpu().numpy()
        codes = idx.codes.cpu().numpy().astype(np.int64)
        dec = cb[np.arange(idx.n_sub)[None, :], codes].reshape(len(codes), DIM)
        pre = (qn @ dec.T) / np.maximum(idx.norms.cpu().numpy()[None, :], 1e-12)
        return ("prescan", pre, idx._rescore_count(10)), None
    proj = kind.endswith("_proj")
    cents = idx.centroids.float().cpu().numpy()
    qsp = qn
    if proj:
        p = idx.proj.cpu().numpy()
        qsp = qn @ p
        qsp = qsp / np.linalg.norm(qsp, axis=1, keepdims=True)
    cell = {int(id_[3:]): c for id_, c in idx._id_to_cell.items()}
    over = {int(id_[3:]) for id_ in idx._overflow._id_to_slot}

    def in_probe(qi, row):
        """The row's list is among the query's top nprobe (or within 1e-5 of
        the nprobe-th centroid score: a near tie of the list choice)."""
        if row in over:
            return True
        cs = qsp[qi] @ cents.T
        return bool(cs[cell[row][0]] >= np.sort(cs)[-NPROBE] - 1e-5)

    def score(qi, row):
        if row in over or (kind == "ivf_pq" and idx.resident == "bf16"):
            xr = x[row] @ p if proj and row in over else x[row]
            return float(exact_scores(qsp[qi:qi + 1] if proj else qn[qi:qi + 1],
                                      xr[None, :], [0])[0, 0])
        lst, pos = cell[row]
        lt = torch.tensor([lst], device=idx.device)
        pt = torch.tensor([pos], device=idx.device)
        if proj:       # rescored against the bf16 shadow of the projected row
            xr = idx.vecs[lt, pt].float().cpu().numpy()[0]
            return float((xr @ qsp[qi]) / np.linalg.norm(xr))
        nrm = float(idx.norms[lt, pt])
        if idx.resident == "int8":
            xr = idx._rows_at(lt, pt).cpu().numpy()[0]
            qb = bf16_rows(qn[qi:qi + 1])[0]
            return min(float(qb @ xr) / nrm, 1.0)
        xr = idx._rows_at(lt, pt).cpu().numpy()[0]        # ADC: the decoded row
        return float(qn[qi] @ xr) / nrm
    return ("probe", in_probe, None), score


def check_quant(kind, idx, corpus, hits):
    """Every returned row passes the kind's candidate check and carries the
    oracle's score for it (within TOL); returns recall@10 against the flat
    oracle."""
    (mode, cand, r), score = quant_oracle(kind, idx, corpus)
    for qi, row in enumerate(hits):
        require(len(row) == 10 and len({i for i, _ in row}) == 10,
                f"{kind} q{qi}: {len(row)} hits, duplicates?")
        if mode == "prescan":
            kth = np.sort(cand[qi])[-r]
            for i, s in row:
                require(cand[qi, i] >= kth - 1e-3, f"{kind} q{qi}: row {i} is not among the "
                        f"prescan's top {r}")
                require(abs(s - float(corpus.scores[qi, i])) <= TOL,
                        f"{kind} q{qi}: score of {i} {s} vs exact {corpus.scores[qi, i]}")
        else:
            for i, s in row:
                require(cand(qi, i), f"{kind} q{qi}: row {i} lies in no probed list")
                want = score(qi, i)
                require(abs(s - want) <= TOL, f"{kind} q{qi}: score of {i} {s} vs oracle {want}")
    return recall_at(hits, corpus.top)


SMALL_KINDS = [
    # (label, kind, corpus, config updates, the probe kernel the path runs)
    ("int8", "int8", "gaussian", {}, None),
    ("pq", "pq", "gaussian", {}, None),
    ("ivf_pq bf16", "ivf_pq", "clustered", {"pq_resident": "bf16"}, None),
    ("ivf_pq int8", "ivf_pq", "clustered", {"pq_resident": "int8"}, None),
    ("ivf_pq none", "ivf_pq", "clustered", {"pq_resident": "none"}, None),
    ("ivf_int8_proj", "ivf_int8_proj", "low-rank", {}, "ivf_probe_int8"),
    ("ivf_int4_proj", "ivf_int4_proj", "low-rank", {}, "ivf_probe_int4"),
]


def small_kind_path(label, kind, corpus, updates, kname, n_shards=None):
    """One kind on its small corpus. ``n_shards`` runs a sharded kind over a
    mesh of that many entries of the card: its search must launch ``kname``
    once a shard, and the shard-plane checks are the sharded phase's."""
    from grape_vector_db_tpu_torch import Document, VectorDatabase, VectorDbConfig

    cfg = VectorDbConfig(vector_dimension=DIM)
    cfg.index.kind = kind
    cfg.index.nlist = IVFPQ_NLIST
    cfg.index.nprobe = NPROBE
    cfg.index.proj_dim = PROJ_DIM
    cfg.device.n_shards = n_shards
    for key, val in updates.items():
        setattr(cfg.index, key, val)
    db = VectorDatabase(config=cfg, device=DEV)
    idx = db.index
    reset_counts()
    t0 = time.perf_counter()
    for start in range(0, corpus.rows, INGEST_BATCH):
        xb = corpus.x[start:start + INGEST_BATCH]
        db.batch_add_documents([Document(id=f"doc{start + i}", content=f"doc {start + i}",
                                         vector=xb[i]) for i in range(len(xb))])
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db.optimize()
    torch.cuda.synchronize()
    optimize_s = time.perf_counter() - t0
    hits = to_rows(db.vector_search_batch(corpus.queries, 10))
    torch.cuda.synchronize()
    launches = read_counts()
    rec = check_quant(kind, idx, corpus, hits)
    med = timed(lambda: db.vector_search_batch(corpus.queries, 10))
    extra = ""
    if kind.endswith("_proj"):
        extra = f", retained energy {idx.proj_energy:.4f}"
        require(launches[kname] > 0, f"{label}: the path never launched {kname}")
        if n_shards:
            require(launches[kname] == n_shards and idx.n_shards == n_shards,
                    f"{label}: {launches[kname]} launches of {kname} for one search over "
                    f"{idx.n_shards} shards")
        require(launches["ivf_group"] == launches[kname],
                f"{label}: the path's probes and grouping passes differ in number")
    log(f"[{label}] {corpus.rows} rows ({corpus.name} corpus; cut from 1M for the time "
        f"limit): ingest {corpus.rows / ingest_s:.0f} docs/s, optimize() {optimize_s:.2f} s"
        f"{extra}; every returned row passes the oracle; recall@10 against the flat oracle "
        f"{rec:.4f}; kernel launches {launches}")
    log(f"[times] {label} vector_search_batch B={BATCH} k=10: median {med * 1e3:.3f} ms of 20 "
        f"({BATCH / med:.0f} queries/s)")
    stats = None
    if kname is not None and not n_shards:
        stats = proj_probe_shapes(kname, idx, corpus)
    db.close()
    return launches, stats


def proj_probe_shapes(name, idx, corpus):
    """B4/B5 against their plain versions at the projected index's shapes
    (D = R = 384)."""
    qt = torch.from_numpy(corpus.queries).to(DEV) @ idx.proj
    qp = torch.nn.functional.normalize(qt, dim=1)
    probe = torch.topk(qp @ idx.centroids.T, NPROBE, dim=1).indices.to(torch.int32)
    return codes_probe_check(name, idx, qp, probe, f"D={PROJ_DIM}")


def codes_probe_check(name, idx, qp, probe, label):
    """B4 or B5 against its plain version on an int8 / int4 IVF index's own
    planes, at the prepared queries and probed lists a search gives it, timed
    in turns, with the bound; then its library composition and its grouping
    pass (``grouped_details``)."""
    from grape_vector_db_tpu_torch.ops import ivf as tivf

    kern, plain = ((tivf.ivf_probe_scores_int8, tivf.ivf_probe_scores_int8_ref)
                   if name == "ivf_probe_int8"
                   else (tivf.ivf_probe_scores_int4, tivf.ivf_probe_scores_int4_ref))
    nb = idx._nblocks()
    data, w = idx.codes, idx.factor
    got = kern(qp, probe, data, w, nb)
    torch.cuda.synchronize()
    want = plain(qp, probe, data, w, nb)
    inv = want == -1e9
    require(torch.equal(got == -1e9, inv), f"{name} {label}: -1e9 positions differ")
    err = (got - want)[~inv].abs().max().item()
    require(err <= TOL, f"{name} {label}: max |score diff| {err} > {TOL}")
    (k1, k2), (p1, p2) = in_turns(lambda: kern(qp, probe, data, w, nb),
                                  lambda: plain(qp, probe, data, w, nb))
    n_lists, cap = w.shape
    (b, d), nprobe = qp.shape, probe.shape[1]
    lim = torch.clamp(nb.long() * 64, max=cap)
    live = (w != 0) & (torch.arange(cap, device=w.device)[None, :] < lim[:, None])
    per_list = live.sum(dim=1)
    row_bytes = data.shape[2] + 4
    unique = int(per_list[torch.unique(probe.long())].sum()) * row_bytes
    ops = 2.0 * int(per_list[probe.long()].sum()) * d
    bnd = bound(unique + b * d * 4 + b * nprobe * cap * 4, ops)
    log(f"[kernels] {name} at {label}: q [{b},{d}] x probe [{b},{nprobe}] over [{n_lists},{cap},"
        f"{data.shape[2]}] {data.dtype}: max_abs_err {err:.3g}")
    log(f"[times] {name} {label}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; "
        f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}")
    stats = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, **bnd}
    stats["library_ms"], stats["library"] = probe_library_ms(name, qp, probe, data, w, nb)
    log(f"[times] {name} {label}: library {stats['library']}: {stats['library_ms']:.4f} ms")
    extra, stats["group"] = grouped_details(name, qp, probe, data, w, nb, label)
    stats.update(extra)
    return stats


# -- the sharded kinds: one process over a mesh of the card ---------------------------

SHARDED_BUDGET_S = 240.0
SHARDED_SHARDS = 4
SHARDED_ROWS = 1 << 21        # 4 shards of 524,288 rows: every shard's search runs B1 / B2
SHARDED_2D_ROWS = 1 << 20     # 2 replica rows x 2 shards of 524,288
# the sharded IVF runs take the first 524,288 rows of the IVF corpus (nlist
# and nprobe as the single card's): for the int8 / int4 runs the first cut
# for the phase's budget (uncut, the phase took 316.0 s of its 240 s on an
# H100), for the bf16 run one for the script's limit (the whole smoke took
# 1,125-1,145 s of its 1,200 on an H100 with the bf16 run at 1,048,576 rows)
SHARDED_IVF_ROWS = 1 << 19
SHARDED_SECONDS = {}          # part of the phase -> its seconds


class ShardPlanes:
    """Shard ``s``'s own planes of a sharded index, where the plane checks
    read an index's (``vectors``, ``norms``, ``valid`` of the flat kind;
    ``vecs``, ``recip``, ``codes``, ``factor``, the centroids and the
    per-shard ``_nblocks()`` of the IVF kinds)."""

    def __init__(self, idx, s: int = 0):
        for name in ("vectors", "norms", "valid", "vecs", "recip", "codes", "factor"):
            t = getattr(idx, name, None)
            setattr(self, name, None if t is None else t.part(s))
        self.centroids = getattr(idx, "centroids", None)
        self._nb = idx._nblocks() if hasattr(idx, "_nblocks") else None

    def _nblocks(self):
        return self._nb


def card_mesh_check(idx, n_shards):
    devs = list(idx.mesh.devices.flat)
    require(idx.n_shards == n_shards and all(d == devs[0] for d in devs)
            and devs[0].type == torch.device(DEV).type,
            f"{idx.kind}: mesh {idx.mesh} is not {n_shards} shards of the card")


def same_answers(name, got, want):
    """Two engines' (row, score) lists: ids as sets with the near-tie guard,
    scores within TOL."""
    for r, (a, b) in enumerate(zip(got, want)):
        ga, gb = dict(a), dict(b)
        require(len(a) == len(b) == len(ga) == len(gb), f"{name} q{r}: {len(a)} vs {len(b)} hits")
        kth = min(gb.values())
        for i in set(ga) ^ set(gb):
            sc = ga.get(i, gb.get(i))
            require(abs(sc - kth) <= TOL, f"{name} q{r}: id {i} (score {sc}) differs away "
                    f"from the k-th score {kth}")
        for i in set(ga) & set(gb):
            require(abs(ga[i] - gb[i]) <= TOL, f"{name} q{r}: score of {i} {ga[i]} vs {gb[i]}")


def sharded_flat_part():
    """``sharded_flat`` at SHARDED_ROWS x 768 over 4 shards of the card
    through ``VectorDatabase``: ingest, k = 10 and k = 3, a 10% filter,
    deletes, ``redistribute`` onto 2 shards; then the 2-D mesh (2 replica
    rows x 2 shards) over the first SHARDED_2D_ROWS rows. Returns (launches
    by kernel, the shard-plane checks of B1 and B2)."""
    from grape_vector_db_tpu_torch import (Condition, Document, Filter, SearchRequest,
                                           VectorDatabase, VectorDbConfig)
    from grape_vector_db_tpu_torch.ops.distance import scored_topk
    from grape_vector_db_tpu_torch.parallel import (make_mesh, replicated_sharded_topk,
                                                    sharded_scored_topk)

    t_part = time.perf_counter()
    rows = SHARDED_ROWS
    # Gaussian rows from a seeded generator on the device (numpy's takes ~10 s)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 16)
    x = np.empty((rows, DIM), np.float32)
    for s in range(0, rows, 65536):
        x[s:s + 65536] = torch.randn((min(65536, rows - s), DIM), generator=gen,
                                     device=DEV).cpu().numpy()
    rng = np.random.default_rng(SEED + 16)
    # half the queries lie near stored documents (of the 2-D part's rows too)
    near = rng.choice(SHARDED_2D_ROWS, BATCH // 2, replace=False)
    queries = np.concatenate([x[near] + 0.5 * rng.standard_normal((BATCH // 2, DIM),
                                                                   dtype=np.float32),
                              rng.standard_normal((BATCH // 2, DIM), dtype=np.float32)])

    def group_of(r):
        return r % 10

    cfg = VectorDbConfig(vector_dimension=DIM)
    cfg.index.kind = "sharded_flat"
    cfg.index.initial_capacity = rows
    cfg.device.n_shards = SHARDED_SHARDS
    db = VectorDatabase(config=cfg, device=DEV)
    idx = db.index
    card_mesh_check(idx, SHARDED_SHARDS)
    require(idx.shard_capacity == rows // SHARDED_SHARDS,
            f"shard capacity {idx.shard_capacity}, wanted {rows // SHARDED_SHARDS}")
    log(f"[sharded] sharded_flat: {idx.n_shards} shards of {idx.shard_capacity} rows, all on "
        f"{idx.device}, metric {idx.metric}, storage {idx.storage_dtype}")
    ingest_s = 0.0
    for start in range(0, rows, INGEST_BATCH):
        xb = x[start:start + INGEST_BATCH]
        docs = [Document(id=f"doc{start + i}", content=f"doc {(start + i) % 997}",
                         vector=xb[i], metadata={"g": int(group_of(start + i))})
                for i in range(len(xb))]
        t0 = time.perf_counter()
        db.batch_add_documents(docs)
        ingest_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    per_shard = [idx.get_stats().extra[f"shard_{i}_points"] for i in range(idx.n_shards)]
    require(len(idx) == rows and idx.capacity == rows and max(per_shard) == min(per_shard),
            f"index holds {len(idx)} rows at capacity {idx.capacity}, {per_shard} a shard")
    log(f"[sharded] sharded_flat ingested {rows} documents in {ingest_s:.2f} s "
        f"({rows / ingest_s:.0f} docs/s, batches of {INGEST_BATCH}); {per_shard} a shard")

    reset_counts()
    batch = db.vector_search_batch(queries, 10)
    c10 = read_counts()
    require(c10["segmax4"] == SHARDED_SHARDS and c10["segmax2"] == 0,
            f"a k=10 search over {SHARDED_SHARDS} shards launched {c10['segmax4']} B1, "
            f"{c10['segmax2']} B2")
    batch3 = db.vector_search_batch(queries, 3)
    c3 = read_counts()
    require(c3["segmax2"] == SHARDED_SHARDS and c3["segmax4"] == c10["segmax4"],
            f"a k=3 search launched {c3['segmax2'] - c10['segmax2']} B2")
    filt = Filter(must=[Condition("g", "eq", 3)])
    filtered = [db.vector_search(SearchRequest(vector=queries[i].tolist(), limit=10,
                                               filter=filt)) for i in range(4)]
    doomed = list(dict.fromkeys(int(p.id[3:]) for row in batch for p in row))[:1024]
    taken = set(doomed)
    doomed += [i for i in range(rows) if i not in taken][:1024 - len(doomed)]
    require(db.batch_delete_documents([f"doc{i}" for i in doomed]) == 1024,
            "sharded_flat: 1024 deletes")
    after = db.vector_search_batch(queries, 10)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[sharded] sharded_flat searches done: batch B={BATCH} k=10 and k=3, 4 x filtered "
        f"k=10, deleted 1024, batch again; kernel launches {launches}")
    require(launches["segmax4"] == SHARDED_SHARDS * (1 + 4 + 1),
            f"sharded_flat: {launches['segmax4']} B1 launches, wanted one a shard a search")

    t0 = time.perf_counter()
    (o_vals, o_ids), (f_vals, f_ids) = oracle(
        ((s, x[s:min(s + 65536, rows)]) for s in range(0, rows, 65536)), queries, group_of)
    check_hits("sharded batch k=10", batch, o_vals, o_ids, 10)
    check_hits("sharded batch k=3", batch3, o_vals, o_ids, 3)
    check_hits("sharded filtered k=10", filtered, f_vals[:4], f_ids[:4], 10)
    require(all(int(p.id[3:]) % 10 == 3 for row in filtered for p in row),
            "a sharded filtered result broke the filter")
    gone = frozenset(doomed)
    check_hits("sharded after delete k=10", after, o_vals, o_ids, 10, exclude=gone)
    top1 = sum(int(batch[i][0].id[3:]) == int(near[i]) for i in range(BATCH // 2))
    log(f"[sharded] sharded_flat answers agree with the numpy oracle (f32 cosine over the "
        f"bf16-rounded corpus, tolerance {TOL}; oracle {time.perf_counter() - t0:.1f} s); "
        f"near-document queries found their document first {top1}/{BATCH // 2}")

    med = timed(lambda: db.vector_search_batch(queries, 10))
    qt = torch.from_numpy(queries).to(DEV)
    chunk = min(idx.search_chunk, idx.shard_capacity)
    sh = lambda: sharded_scored_topk(qt, idx.vectors, idx.norms, idx.valid, 10, "cosine", chunk,
                                     idx.mesh)
    whole = [t.to_global(DEV) for t in (idx.vectors, idx.norms, idx.valid)]
    un = lambda: scored_topk(qt, *whole, 10, chunk=65536)
    sv, ss = sh()
    uv, us = un()
    torch.cuda.synchronize()
    require(torch.allclose(sv, uv, atol=TOL, rtol=0),
            "the sharded call and the same call on the whole plane disagree")
    (u1, u2), (s1, s2) = in_turns(un, sh, 10, 10)
    del whole
    log(f"[times] sharded_flat ({CARD}): vector_search_batch B={BATCH} k=10 at {rows - 1024} "
        f"documents over {SHARDED_SHARDS} shards: median {med * 1e3:.3f} ms of 20 "
        f"({BATCH / med:.0f} queries/s); ingest {rows / ingest_s:.0f} docs/s")
    log(f"[times] sharded_flat device span of one call (CUDA events, in turns): "
        f"sharded_scored_topk over {SHARDED_SHARDS} shards {s1:.3f} / {s2:.3f} ms (four B1 "
        f"launches in sequence on one stream, then the merge), scored_topk on the same "
        f"[{rows},{DIM}] plane unsharded {u1:.3f} / {u2:.3f} ms")
    planes = {name: index_plane_check("sharded shard 0", name, ShardPlanes(idx, 0), queries)
              for name in ("segmax4", "segmax2")}

    # the same corpus on 2 shards of 1,048,576 (a node leaves)
    t0 = time.perf_counter()
    idx.redistribute(make_mesh(2, devices=[torch.device(DEV)]), shard_capacity=rows // 2)
    torch.cuda.synchronize()
    red_s = time.perf_counter() - t0
    card_mesh_check(idx, 2)
    reset_counts()
    moved = db.vector_search_batch(queries, 10)
    c = read_counts()
    require(c["segmax4"] == 2, f"the 2-shard search launched {c['segmax4']} B1")
    check_hits("redistributed k=10", moved, o_vals, o_ids, 10, exclude=gone)
    launches["segmax4"] += c["segmax4"]
    log(f"[sharded] redistribute onto 2 shards of {rows // 2}: {red_s:.2f} s; "
        f"{len(idx)} rows; the search is exact against the oracle")
    db.close()
    del db, idx
    torch.cuda.empty_cache()
    SHARDED_SECONDS["flat 1-D"] = time.perf_counter() - t_part

    # -- 2-D: 2 replica rows x 2 shards; the batch splits 64 to a row
    t_part = time.perf_counter()
    rows2 = SHARDED_2D_ROWS
    cfg = VectorDbConfig(vector_dimension=DIM)
    cfg.index.kind = "sharded_flat"
    cfg.index.initial_capacity = rows2
    cfg.device.n_shards, cfg.device.n_replicas = 2, 2
    db = VectorDatabase(config=cfg, device=DEV)
    idx = db.index
    require(idx.replica_axis == "replica" and idx.n_replicas == 2 and idx.n_shards == 2
            and idx.shard_capacity == rows2 // 2, f"2-D mesh {idx.mesh}")
    t0 = time.perf_counter()
    idx.add_batch([f"doc{i}" for i in range(rows2)], x[:rows2])   # the index directly
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    reset_counts()
    two = db.vector_search_batch(queries, 10)
    c = read_counts()
    require(c["segmax4"] == 4, f"the 2-D search launched {c['segmax4']} B1 (2 rows x 2 shards)")
    launches["segmax4"] += c["segmax4"]
    (p_vals, p_ids), _ = oracle(((s, x[s:min(s + 65536, rows2)])
                                 for s in range(0, rows2, 65536)), queries, group_of)
    check_hits("2-D k=10", two, p_vals, p_ids, 10)
    one_v, one_s = sharded_scored_topk(qt, idx.vectors, idx.norms, idx.valid, 10, "cosine",
                                       chunk, idx.mesh)
    two_v, two_s = replicated_sharded_topk(qt, idx.vectors, idx.norms, idx.valid, 10, "cosine",
                                           chunk, idx.mesh)
    same_answers("2-D against 1-D", [list(zip(a.tolist(), b.tolist())) for a, b in
                                     zip(two_s.cpu(), two_v.cpu())],
                 [list(zip(a.tolist(), b.tolist())) for a, b in zip(one_s.cpu(), one_v.cpu())])
    med2 = timed(lambda: db.vector_search_batch(queries, 10))
    log(f"[sharded] 2-D sharded_flat: 2 replica rows x 2 shards of {rows2 // 2} on the card; "
        f"{rows2} rows by index.add_batch in {add_s:.2f} s; B={BATCH} splits {BATCH // 2} to "
        f"a row; exact against the oracle over its rows, and equal to the same shards "
        f"searched 1-D")
    log(f"[times] 2-D sharded_flat ({CARD}): vector_search_batch B={BATCH} k=10: median "
        f"{med2 * 1e3:.3f} ms of 20 ({BATCH / med2:.0f} queries/s)")
    db.close()
    del db, idx, x
    torch.cuda.empty_cache()
    SHARDED_SECONDS["flat 2-D"] = time.perf_counter() - t_part
    return ({"segmax4": launches["segmax4"], "segmax2": launches["segmax2"]}, planes)


def sharded_ivf_part(kind: str, corpus: "Clustered", nlist: int, single: dict, rows: int):
    """``sharded_<kind>`` over 4 shards of the card on the first ``rows`` of
    the IVF corpus: first with the single-card index's centroids (its lists,
    its deletes, and where ``rows`` is a cut, the single card's index with
    the other rows deleted: the same answers), then ``optimize()``, search,
    filtered search on both exact tiers, deletes and search again against
    the numpy oracles, as ``ivf_path`` holds the single-card kind. Closes
    the single card's database. Returns (launches, the probe kernel's check
    on shard 0's planes)."""
    from grape_vector_db_tpu_torch import (Condition, Document, Filter, SearchRequest,
                                           VectorDatabase, VectorDbConfig)

    t_part = time.perf_counter()
    sdb = single.pop("db")
    if rows < corpus.rows:     # the single card's index over the same rows
        sdb.index.remove_batch([f"doc{i}" for i in range(rows, corpus.rows)])
        single["after"] = to_rows(sdb.vector_search_batch(corpus.queries, 10))
    sdb.close()
    del sdb
    torch.cuda.empty_cache()
    single_doomed = [i for i in single["doomed"] if i < rows]
    cfg = VectorDbConfig(vector_dimension=DIM)
    cfg.index.kind = f"sharded_{kind}"
    cfg.index.nlist = nlist
    cfg.index.nprobe = NPROBE
    # lists as long as the single-card index's, so its centroids place every row
    cfg.index.initial_capacity = nlist * single["list_cap"]
    cfg.device.n_shards = SHARDED_SHARDS
    db = VectorDatabase(config=cfg, device=DEV)
    idx = db.index
    card_mesh_check(idx, SHARDED_SHARDS)
    quant = kind != "ivf"
    check = check_members if quant else check_exact
    kname = IVF_KERNEL[kind]
    group = np.arange(corpus.rows) % 10
    everyone = list(range(BATCH))
    tag = f"[sharded_{kind}]"
    idx.centroids = single["centroids"]
    reset_counts()
    ingest_s = 0.0
    for start in range(0, rows, INGEST_BATCH):
        xb = corpus.x[start:start + INGEST_BATCH]
        docs = [Document(id=f"doc{start + i}", content=f"doc {(start + i) % 997}",
                         vector=xb[i], metadata={"g": int(group[start + i])})
                for i in range(len(xb))]
        t0 = time.perf_counter()
        db.batch_add_documents(docs)
        ingest_s += time.perf_counter() - t0
    torch.cuda.synchronize()
    require(len(idx) == rows and len(idx._overflow) == 0 and idx.list_cap == single["list_cap"],
            f"{kind}: {len(idx)} rows, {len(idx._overflow)} in the overflow, list_cap "
            f"{idx.list_cap}")
    fill = np.asarray(idx.valid).reshape(idx.nlist, SHARDED_SHARDS, -1).sum(axis=2)
    require(int((fill.max(axis=1) - fill.min(axis=1)).max()) <= 1,
            f"{kind}: striped placement left a list's shards uneven")
    require(db.batch_delete_documents([f"doc{i}" for i in single_doomed]) == len(single_doomed),
            f"{kind}: the single-card index's deletes")
    carried = to_rows(db.vector_search_batch(corpus.queries, 10))
    c = read_counts()
    require(c[kname] == SHARDED_SHARDS, f"{kind}: {c[kname]} launches of {kname} for one "
            f"search over {SHARDED_SHARDS} shards")
    cands = probed_candidates(idx, corpus, everyone)
    rec_c, n_c = check("carried centroids k=10", carried, corpus, everyone, cands, 10)
    if quant:
        # each shard rescores its own top candidates, a superset of the
        # single card's: rank for rank its scores are at least as high
        for r, (a, b) in enumerate(zip(carried, single["after"])):
            sa, sb = sorted((s for _, s in a), reverse=True), sorted((s for _, s in b), reverse=True)
            require(all(x_ >= y_ - TOL for x_, y_ in zip(sa, sb)),
                    f"{kind} q{r}: the sharded answer ranks below the single card's")
        differ = sum({i for i, _ in a} != {i for i, _ in b}
                     for a, b in zip(carried, single["after"]))
        same = f"scores rank for rank at least the single card's; {differ} of {BATCH} id sets differ"
    else:
        same_answers(f"{kind} against the single card", carried, single["after"])
        same = "the same answers as the single card"
    log(f"{tag} {SHARDED_SHARDS} shards of {idx.list_cap // SHARDED_SHARDS} columns a list; "
        f"ingested {rows} with the single card's centroids in {ingest_s:.2f} s "
        f"({rows / ingest_s:.0f} docs/s), striped; after its {len(single_doomed)} deletes "
        f"(and the rows past {rows} deleted from the single card's index): {same}; exact over "
        f"the probed lists ({n_c} queries checked, recall@10 {rec_c:.4f})")

    t0 = time.perf_counter()
    db.optimize()
    torch.cuda.synchronize()
    optimize_s = time.perf_counter() - t0
    batch = to_rows(db.vector_search_batch(corpus.queries, 10))
    f10 = [to_rows([db.vector_search(SearchRequest(
        vector=corpus.queries[i].tolist(), limit=10,
        filter=Filter(must=[Condition("g", "eq", 3)])))])[0] for i in range(4)]
    compact_used = idx._compact_cache is not None
    idx.compact_max_bytes = 0                      # the streaming tier
    with idx.locked():
        mask = idx.compile_mask({f"doc{r}" for r in np.flatnonzero(group == 3)})
        stream = to_rows(idx.search_batch(corpus.queries, 10, mask=mask, exhaustive=True))
    del idx.compact_max_bytes
    post = probed_candidates(idx, corpus, everyone)
    doomed = list(dict.fromkeys(i for row in batch for i, _ in row))[:1000]
    require(db.batch_delete_documents([f"doc{i}" for i in doomed]) == len(doomed),
            f"{kind}: deletes after optimize")
    after = to_rows(db.vector_search_batch(corpus.queries, 10))
    torch.cuda.synchronize()
    launches = read_counts()
    require(compact_used, f"sharded {kind}: the 10% filter did not take the compact tier")
    # one probe a shard for each of the 3 batch searches and the streaming tier's phase 2
    require(launches[kname] == 4 * SHARDED_SHARDS,
            f"sharded {kind}: {launches[kname]} launches of {kname}, wanted one a shard a probe")
    if quant:
        require(launches["ivf_group"] == launches[kname],
                f"sharded {kind}: probes and grouping passes differ in number")
    rec, n_ok = check("after optimize k=10", batch, corpus, everyone, post, 10)
    live3 = group == 3                             # the filter over the live rows
    live3[single_doomed] = False
    live3[rows:] = False
    check_exact("filtered 10% (compact tier) k=10", f10, corpus, range(4), [live3] * 4, 10)
    if quant:
        rec_s = recall_full(stream, corpus, live3)
        require(all(live3[i] for row in stream for i, _ in row)
                and all(len(row) == 10 for row in stream),
                f"sharded {kind}: the streaming tier broke the filter")
    else:
        rec_s, _ = check_exact("streaming tier k=10", stream, corpus, everyone,
                               [live3] * BATCH, 10)
    gone = set(doomed) | set(single_doomed)
    require(not any(i in gone for row in after for i, _ in row),
            f"sharded {kind}: a deleted id came back")
    rec_a, _ = check("after delete k=10", after, corpus, everyone,
                     probed_candidates(idx, corpus, everyone), 10)
    med = timed(lambda: db.vector_search_batch(corpus.queries, 10))
    log(f"{tag} optimize() {optimize_s:.2f} s: list_cap {idx.list_cap}; answers agree with the "
        f"numpy oracles ({n_ok} queries checked; recall@10 against the probed-lists oracle "
        f"{rec:.4f}, after delete {rec_a:.4f}; compact tier exact; streaming tier recall@10 "
        f"{rec_s:.4f}); kernel launches {launches}")
    log(f"[times] sharded_{kind} ({CARD}): vector_search_batch B={BATCH} k=10 over "
        f"{SHARDED_SHARDS} shards: median {med * 1e3:.3f} ms of 20 ({BATCH / med:.0f} "
        f"queries/s); ingest {rows / ingest_s:.0f} docs/s; optimize {optimize_s:.2f} s")
    log(f"[sharded] {kname} on shard 0's own lists [{idx.nlist},{idx.list_cap // SHARDED_SHARDS}]:")
    stats = probe_main_shapes(kind, ShardPlanes(idx, 0), corpus)
    stats.pop("library", None)
    db.close()
    SHARDED_SECONDS[f"sharded_{kind}"] = time.perf_counter() - t_part
    return launches, stats


def sharded_report():
    total = sum(SHARDED_SECONDS.values())
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in SHARDED_SECONDS.items())
    if SHARDED_IVF_ROWS < QUANT_ROWS:
        log(f"[sharded] cut: sharded_ivf / _int8 / _int4 at {SHARDED_IVF_ROWS} of the IVF "
            f"corpus's {QUANT_ROWS} rows (nlist, nprobe and D as the single card's)")
    log(f"[time] sharded phase {total:.1f} s ({parts}; budget {SHARDED_BUDGET_S:.0f} s"
        f"{', over it' if total > SHARDED_BUDGET_S else ''})")



# -- graph search (kind="graph") and B11 ----------------------------------------------


def gather_check(label, q, v, ids, route=None):
    """B11 against its plain version on the card: every entry within 1e-4 of
    its sum of |q_d v_d| (f32 sums in another order). Returns the largest
    difference."""
    from grape_vector_db_tpu_torch.ops import gather

    got = gather.gather_dots(q, v, ids, route=route)
    torch.cuda.synchronize()
    want = gather.gather_dots_ref(q, v, ids)
    scale = gather.gather_dots_ref(q.abs(), v.abs(), ids)
    diff = (got - want).abs()
    require(bool((diff <= 1e-4 * scale + 1e-30).all()),
            f"gather_dots {label} ({route or 'rule'}): kernel and plain version differ by up "
            f"to {diff.max().item():.3g} (allowance 1e-4 of the |q.v| sum)")
    return diff.max().item()


def gather_exact(label, q, v, ids, route=None):
    """B11 equal to its plain version, value for value (exact sums)."""
    from grape_vector_db_tpu_torch.ops import gather

    got = gather.gather_dots(q, v, ids, route=route)
    torch.cuda.synchronize()
    require(torch.equal(got, gather.gather_dots_ref(q, v, ids)),
            f"gather_dots {label} ({route or 'rule'}): kernel and plain version differ on "
            f"exact sums")


def routes_of(v):
    """The routes a call over this storage can take (the grouped one is bf16's)."""
    return ("pairs", "grouped") if v.dtype == torch.bfloat16 else ("pairs",)


def group_check(ids, n):
    """The card's grouping pass against its plain version: rep equal, the
    same first copies, each (query group, row) key one contiguous run, the
    query groups in order. Returns (distinct pairs, distinct rows)."""
    from grape_vector_db_tpu_torch.ops import gather

    order, rep, totals = gather.group_pairs(ids, n)
    o_ref, rep_ref, t_ref = gather.group_pairs_ref(ids, n)
    torch.cuda.synchronize()
    pu = int(totals.sum())
    b, c = ids.shape
    rows = (ids.clamp(0, n - 1).long() + (torch.arange(b, device=ids.device)
                                          // gather.GROUP_QUERIES * n)[:, None]).reshape(-1)
    keys = rows[order[:pu].long()]
    runs = int((keys[1:] != keys[:-1]).sum()) + 1 if pu else 0
    require(torch.equal(rep, rep_ref) and torch.equal(totals, t_ref)
            and torch.equal(torch.sort(order[:pu]).values, torch.sort(o_ref[:pu]).values)
            and runs == int(torch.unique(keys).numel())
            and bool((keys[1:] // n >= keys[:-1] // n).all()),
            f"group_pairs [{b},{c}]: the card's grouping disagrees with its plain version")
    return pu, int(torch.unique(ids.clamp(0, n - 1)).numel())


def device_ms(fn, reps=10):
    """Device milliseconds a call of fn by kernel name, from torch.profiler
    (CUPTI) over reps calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t > 0:
            out[e.key] = out.get(e.key, 0.0) + t / reps / 1e3
    return out


def gather_times(label, q, v, ids, reps_k, reps_p):
    """Both routes and the plain version timed in turns (plain, pairs,
    grouped, grouped, pairs, plain; the pairs route is the parent tree's
    kernel, unchanged), the grouped route's device time by kernel
    (torch.profiler), the library route (the row gather + torch.bmm: two
    calls, the rows materialized), and the bound: the distinct rows the ids
    name, each read once, plus q, the ids and the output, against 2 B C D
    operations at the bf16 peak. "ms" is the route the rule picks
    ("rule_picks"), whole call."""
    from grape_vector_db_tpu_torch.ops import gather

    b, c = ids.shape
    n, d = v.shape
    route = gather.gather_route(b, c, d, v.dtype)
    routes = routes_of(v)
    t = {"plain": [], **{r: [] for r in routes}}
    t["plain"].append(cuda_ms(lambda: gather.gather_dots_ref(q, v, ids), reps_p))
    for r in routes + routes[::-1]:
        t[r].append(cuda_ms(lambda: gather.gather_dots(q, v, ids, route=r), reps_k))
    t["plain"].append(cuda_ms(lambda: gather.gather_dots_ref(q, v, ids), reps_p))
    qc = q.to(v.dtype)[:, :, None]
    lib = cuda_ms(lambda: torch.bmm(v[ids.long()], qc), reps_p)
    distinct = int(torch.unique(ids.clamp(0, n - 1)).numel())
    esize = v.element_size()
    nbytes = distinct * d * esize + q.numel() * 4 + 2 * ids.numel() * 4
    stats = {"ms": sum(t[route]) / 2, "plain_ms": sum(t["plain"]) / 2,
             **bound(nbytes, 2.0 * b * c * d), "library_ms": lib, "rule_picks": route,
             "pairs_ms": sum(t["pairs"]) / 2, "pairs_per_distinct_row": b * c / distinct}
    tile = (c + 31) // 32
    moved = {"pairs": b * c * d * esize + b * tile * d * 4}
    line = ""
    if "grouped" in routes:
        pu, _ = group_check(ids, n)
        dev = device_ms(lambda: gather.gather_dots(q, v, ids, route="grouped"))
        names = {"group": ("memset", "dedup_count", "offsets", "scatter", "elementwise"),
                 "kernel": ("grouped_kernel",), "expand": ("expand_kernel",)}
        split = {k: sum(ms_ for key, ms_ in dev.items() if any(w in key.lower() for w in ws))
                 for k, ws in names.items()}
        grid = min(torch.cuda.get_device_properties(0).multi_processor_count,
                   -(-b * c // 2048))
        dp = -(-d // 64) * 64
        moved["grouped"] = (pu * d * esize + grid * min(b, gather.GROUP_QUERIES) * dp * 2)
        stats.update({"grouped_ms": sum(t["grouped"]) / 2, "grouping_device_ms": split["group"],
                      "grouped_kernel_device_ms": split["kernel"],
                      "expand_device_ms": split["expand"], "distinct_pairs": pu})
        line = (f"; grouped {t['grouped'][0]:.4f} / {t['grouped'][1]:.4f} ms (device: grouping "
                f"pass {split['group']:.4f} incl. the bf16 cast of q, kernel "
                f"{split['kernel']:.4f}, expand {split['expand']:.4f}); {pu} distinct (query, "
                f"row) pairs of {b * c} ({b * c / max(pu, 1):.2f} copies each)")
    stats["bytes_into_sms"] = moved
    log(f"[times] gather_dots {label} (B={b}, C={c}, D={d}, {v.dtype}; rule picks {route}): "
        f"pairs (the parent's kernel) {t['pairs'][0]:.4f} / {t['pairs'][1]:.4f} ms{line}; "
        f"plain {t['plain'][0]:.4f} / {t['plain'][1]:.4f} ms, library (row gather + torch.bmm, "
        f"two calls) {lib:.4f} ms; {distinct} distinct rows of {b * c} pairs "
        f"({b * c / distinct:.2f} pairs a row; {distinct * d * esize / 1e6:.1f} MB; every "
        f"candidate read {b * c * d * esize / 1e6:.1f} MB); bytes into the SMs, estimated from "
        f"the counts: " + ", ".join(f"{k} {x / 1e6:.1f} MB" for k, x in moved.items())
        + f"; bound {stats['bound_ms']:.4f} ms by {stats['bound_by']}")
    return stats


def route_crossover(q, v, ids):
    """Both routes in turns (pairs, grouped, grouped, pairs) over the first
    B rows of a real build chunk, C = 576: where the rule's threshold
    (GROUPED_MIN_PAIRS) should sit."""
    from grape_vector_db_tpu_torch.ops import gather

    rows = []
    for b in (256, 512, 768, 1024, 1536, 2048):
        qb, ib = q[:b].contiguous(), ids[:b].contiguous()
        t = {"pairs": [], "grouped": []}
        for r in ("pairs", "grouped", "grouped", "pairs"):
            t[r].append(cuda_ms(lambda: gather.gather_dots(qb, v, ib, route=r), 10))
        rows.append((b * ib.shape[1], sum(t["pairs"]) / 2, sum(t["grouped"]) / 2))
    log("[times] gather_dots routes by pairs (real build ids, C=576, bf16; in turns): "
        + "; ".join(f"{p}: pairs {a:.4f} ms, grouped {g:.4f} ms" for p, a, g in rows)
        + f"; the rule's threshold {gather.GROUPED_MIN_PAIRS} pairs")
    return rows


def group_times(ids, n):
    """The grouping pass alone at the build shape: its device time (kernels
    and memset, torch.profiler) against its plain version's; bound: read the
    ids, write rep and the distinct pairs' order."""
    from grape_vector_db_tpu_torch.ops import gather

    dev = device_ms(lambda: gather.group_pairs(ids, n))
    ms_ = sum(x for key, x in dev.items()
              if any(w in key.lower() for w in ("memset", "dedup_count", "offsets", "scatter")))
    plain = cuda_ms(lambda: gather.group_pairs_ref(ids, n), 3)
    pu = int(gather.group_pairs(ids, n)[2].sum())
    stats = {"max_abs_err": 0.0, "ms": ms_, "plain_ms": plain,
             **bound(ids.numel() * 8 + pu * 4, 0.0), "library_ms": None}
    log(f"[times] gather grouping pass [{ids.shape[0]},{ids.shape[1]}] over {n} rows: device "
        f"{ms_:.4f} ms (memset, dedup + count, offsets, scatter), plain version (torch sort, "
        f"argsort) {plain:.4f} ms; bound {stats['bound_ms']:.4f} ms by bytes")
    return stats


def gather_phase(idx, beam_calls):
    """B11 against its plain version at the three shapes of the graph path,
    with the ids of a real entry step and beam iteration (``beam_calls``)
    and of a real build round (the NN-descent join over the built graph),
    through each route a call can take (pairs; in bf16 storage also
    grouped): Gaussian rows within 1e-4 of the |q.v| sum (bf16 and f32
    storage), small integers equal value for value, two grouped calls equal
    bit for bit, ragged shapes, a hot row, query groups and out-of-range ids
    alike. Returns the stats of the beam shape, the build shape and the
    grouping pass."""
    from grape_vector_db_tpu_torch.ops import gather
    from grape_vector_db_tpu_torch.ops.distance import prepare_queries
    from grape_vector_db_tpu_torch.ops.graph import join_candidates

    dev = torch.device(DEV)
    v = idx._graph_store.vectors[:idx._nb_cap]
    n = v.shape[0]
    cand = join_candidates(idx.neighbors.cpu().numpy(), min(idx.degree, 8))
    shapes = {"beam": beam_calls[len(beam_calls) // 2],     # a middle beam iteration
              "entry": beam_calls[0],                       # the entry step
              "build": (prepare_queries(v[:2048].float(), "cosine"),
                        torch.from_numpy(cand[:2048]).to(dev))}
    rng = np.random.default_rng(SEED + 11)
    vi = torch.from_numpy(rng.integers(-3, 4, (n, DIM)).astype(np.float32)).to(dev)
    errs = {}
    for label, (q, ids) in shapes.items():
        b, c = ids.shape
        errs[label] = max(max(gather_check(f"{label} bf16", q, v, ids, r) for r in routes_of(v)),
                          gather_check(f"{label} f32 storage", q, v.float(), ids))
        qi = torch.from_numpy(rng.integers(-3, 4, (b, DIM)).astype(np.float32)).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            for r in routes_of(vi.to(dtype)):
                gather_exact(f"{label} integer {dtype}", qi, vi.to(dtype), ids, r)
        g1 = gather.gather_dots(q, v, ids, route="grouped")
        require(torch.equal(g1, gather.gather_dots(q, v, ids, route="grouped")),
                f"gather_dots {label}: two grouped calls differ")
        log(f"[kernels] gather_dots {label}: q [{b},{DIM}] x ids [{b},{c}] (real ids) over "
            f"[{n},{DIM}], rule picks {gather.gather_route(b, c, DIM, v.dtype)}: max_abs_err "
            f"{errs[label]:.3g} (bf16 through both routes and f32 storage, within 1e-4 of the "
            f"|q.v| sum); small integers equal value for value (bf16 both routes, f32); two "
            f"grouped calls equal bit for bit")
    hot = torch.full((2048, 576), 7, dtype=torch.int32, device=dev)
    q_hot = torch.from_numpy(rng.integers(-3, 4, (2048, DIM)).astype(np.float32)).to(dev)
    gather_exact("hot row B=2048 C=576 bf16", q_hot, vi.to(torch.bfloat16), hot, "grouped")
    many = torch.from_numpy(rng.integers(0, n, (1300, 64)).astype(np.int32)).to(dev)
    q_many = torch.from_numpy(rng.integers(-3, 4, (1300, DIM)).astype(np.float32)).to(dev)
    gather_exact("three query groups B=1300 C=64 bf16", q_many, vi.to(torch.bfloat16), many,
                 "grouped")
    for d in (100, 1536, 1):
        vr = torch.from_numpy(rng.integers(-3, 4, (300, d)).astype(np.float32)).to(dev)
        qr = torch.from_numpy(rng.integers(-3, 4, (5, d)).astype(np.float32)).to(dev)
        ids = torch.from_numpy(rng.integers(0, 300, (5, 37)).astype(np.int32)).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            for r in routes_of(vr.to(dtype)):
                gather_exact(f"ragged B=5 C=37 D={d} {dtype}", qr, vr.to(dtype), ids, r)
    wild = torch.tensor([[0, -1, 5, n], [n - 1, -7, n + 60, -1], [1, 2, 3, 1 << 30],
                         [-(1 << 30), 4, 0, 7]], dtype=torch.int32, device=dev)
    qw = torch.from_numpy(rng.integers(-3, 4, (4, DIM)).astype(np.float32)).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        vw = vi.to(dtype)
        for r in routes_of(vw):
            gather_exact(f"out-of-range ids {dtype}", qw, vw, wild, r)
            require(torch.equal(gather.gather_dots(qw, vw, wild, route=r),
                                gather.gather_dots(qw, vw, wild.clamp(0, n - 1), route=r)),
                    f"gather_dots ({r}): out-of-range ids do not clamp")
    log("[kernels] gather_dots hot row (2048 x 576 ids all 7), three query groups (B=1300), "
        "ragged (B=5, C=37, D=100, 1536 and 1; bf16 and f32), both routes: equal; negative and "
        "too-large ids clamp to rows 0 and N-1 in kernel and plain version alike")
    del vi
    out = {}
    for label, key, reps in (("beam", "gather_dots", (20, 5)), ("entry", "entry", (20, 5)),
                             ("build", "gather_dots@build", (10, 3))):
        q, ids = shapes[label]
        out[key] = {"max_abs_err": errs[label], **gather_times(label, q, v, ids, *reps)}
    out["gather_dots"]["entry"] = out.pop("entry")
    q_build, ids_build = shapes["build"]
    out["gather_dots@build"]["routes_by_pairs"] = route_crossover(q_build, v, ids_build)
    out["gather_group"] = group_times(ids_build, n)
    return out


def graph_path(corpus):
    """kind="graph" with the config defaults (m 16 -> degree 32, ef_search
    100 -> pool 128, ef_construction 200 -> 12 rounds; 64 entries, expand 8;
    cosine, bf16) over the clustered corpus, ingested in batches of 8192
    (the reference's rebuild rule rebuilds at every 25% of growth), then
    optimize(), search, filtered search, deletes and an upsert into the fresh
    region, each against the numpy oracle. Returns (search launches, build
    launches, kernel stats)."""
    from grape_vector_db_tpu_torch import (Condition, Document, Filter, SearchRequest,
                                           VectorDatabase, VectorDbConfig)
    from grape_vector_db_tpu_torch.index.graph import _probe_entries
    from grape_vector_db_tpu_torch.ops import graph as tgraph

    t_phase = time.perf_counter()
    rows = corpus.rows
    cfg = VectorDbConfig(vector_dimension=DIM)
    cfg.index.kind = "graph"
    db = VectorDatabase(config=cfg, device=DEV)
    idx = db.index
    log(f"[graph] VectorDatabase: {rows} rows ({corpus.name} corpus), degree {idx.degree}, "
        f"pool {idx.pool}, {idx.build_rounds} rounds, {idx.n_entries} entries, expand "
        f"{idx.expand}, {idx.search_iters} iterations, metric {idx.metric}")

    reset_counts()
    t0 = time.perf_counter()
    for start in range(0, rows, INGEST_BATCH):
        xb = corpus.x[start:start + INGEST_BATCH]
        db.batch_add_documents([Document(id=f"doc{start + i}", content=f"doc {start + i}",
                                         vector=xb[i], metadata={"g": (start + i) % 10})
                                for i in range(len(xb))])
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    ingest_builds = idx.builds
    t0 = time.perf_counter()
    db.optimize()
    torch.cuda.synchronize()
    optimize_s = time.perf_counter() - t0
    counts = read_counts()
    build_launches, build_grouped = counts["gather_dots"], counts["gather_dots_grouped"]
    group_launches = counts["gather_group"]
    require(build_launches > 0, "the graph build never launched gather_dots")
    require(build_grouped > 0 and group_launches == build_grouped,
            f"the graph build took the grouped route {build_grouped} times with "
            f"{group_launches} grouping passes")
    require(len(idx) == rows and idx.get_stats().extra["fresh"] == 0,
            f"graph: {len(idx)} rows, fresh {idx.get_stats().extra['fresh']}")
    log(f"[graph] ingested {rows} in {ingest_s:.2f} s ({rows / ingest_s:.0f} docs/s) with "
        f"{ingest_builds} builds; optimize() (one more full build) {optimize_s:.2f} s; "
        f"B11 launches in the builds {build_launches} ({build_grouped} through the grouped route, "
        f"each after one grouping pass); {idx.get_stats().memory_usage_mb:.0f} MB")

    builds = idx.builds
    qs = corpus.queries
    reset_counts()
    batch = to_rows(db.vector_search_batch(qs, 10))
    single = [to_rows([db.vector_search(SearchRequest(vector=qs[i].tolist(), limit=10))])[0]
              for i in range(4)]
    filt = Filter(must=[Condition("g", "eq", 3)])
    filtered = [to_rows([db.vector_search(SearchRequest(vector=qs[i].tolist(), limit=10,
                                                        filter=filt))])[0] for i in range(8)]
    gone = sorted({i for row in batch[:16] for i, _ in row})
    n_del = db.batch_delete_documents([f"doc{i}" for i in gone])
    require(n_del == len(gone), f"graph: deleted {n_del} of {len(gone)}")
    after = to_rows(db.vector_search_batch(qs[:16], 10))
    # upsert: 1000 existing ids get new vectors, which go to the fresh region
    rng = np.random.default_rng(SEED + 12)
    up_rows = np.arange(rows - 1000, rows)
    newv = (corpus.x[rng.integers(0, rows, 1000)]
            + 0.5 * rng.standard_normal((1000, DIM), dtype=np.float32)).astype(np.float32)
    db.batch_add_documents([Document(id=f"doc{r}", content=f"doc {r} v2", vector=newv[i],
                                     metadata={"g": int(r % 10)})
                            for i, r in enumerate(up_rows)])
    fresh = idx.get_stats().extra["fresh"]
    up_hits = to_rows(db.vector_search_batch(newv[:32], 1))
    old_hits = to_rows(db.vector_search_batch(corpus.x[up_rows[:32]], 10))
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["gather_dots"]
    require(launches > 0, "graph search never launched gather_dots")
    require(counts["gather_dots_grouped"] == 0,
            "graph search took the grouped route (the rule gives the beam the pairs route)")
    require(idx.builds == builds and fresh == 1000,
            f"graph: a build ran inside the search window, or fresh holds {fresh}")
    log(f"[graph] searches done: batch B={BATCH} k=10, 4 x k=10, 8 x filtered k=10, deleted "
        f"{n_del} (the top hits of 16 queries), batch again, upserted 1000 rows into the fresh "
        f"region, 32 + 32 searches; B11 launches {launches} (all through the pairs route)")

    for name, hits in (("batch", batch), ("single", single)):
        for r, row in enumerate(hits):
            require(len(row) == 10 and len({i for i, _ in row}) == 10,
                    f"graph {name} q{r}: {len(row)} hits, duplicates?")
            for i, s in row:
                require(abs(s - float(corpus.scores[r, i])) <= TOL,
                        f"graph {name} q{r}: score of {i} {s} vs oracle {corpus.scores[r, i]}")
    rec = recall_at(batch, corpus.top)
    require(rec >= 0.85, f"graph recall@10 {rec:.4f} < 0.85")
    n_filt = sum(len(row) for row in filtered)
    require(n_filt > 0 and all(i % 10 == 3 for row in filtered for i, _ in row),
            "graph: a filtered result broke the filter (or none came back)")
    alive = np.ones(rows, bool)
    alive[gone] = False
    require(all(len(row) == 10 and not any(not alive[i] for i, _ in row) for row in after),
            "graph: a deleted id came back")
    first = sum(row[0][0] == int(up_rows[i]) for i, row in enumerate(up_hits))
    require(first == 32, f"graph: {first}/32 upserted rows found first")
    for i, row in enumerate(old_hits):
        r = int(up_rows[i])
        for j, s in row:
            if j == r:   # the id now carries its new vector's score
                want = float(exact_scores(corpus.x[r:r + 1] / np.linalg.norm(corpus.x[r]),
                                          newv, [i])[0, 0])
                require(abs(s - want) <= TOL, f"graph: upserted doc{r} kept its old score")
    log(f"[graph] answers agree with the numpy oracle: ids distinct, every score within "
        f"{TOL} of the oracle's; recall@10 against the flat oracle {rec:.4f} (floor 0.85); "
        f"filtered 10%: {n_filt} hits of 8 queries (over-fetch + host filter), all in the "
        f"filter; deleted ids never return (recall after delete "
        f"{recall_full(after, corpus, alive):.4f}); 32/32 upserted rows found first through "
        f"the fresh region; builds {idx.builds:.0f}")

    med = timed(lambda: db.vector_search_batch(qs, 10))
    single_t = []
    for i in range(100):
        req = SearchRequest(vector=qs[i % BATCH].tolist(), limit=10)
        t0 = time.perf_counter()
        db.vector_search(req)
        single_t.append(time.perf_counter() - t0)
    single_t.sort()
    index_ms = timed(lambda: idx.search_batch(qs, 10)) * 1e3

    # the ids of a real search: its entry step and its beam iterations
    calls = []
    inner = tgraph.gather_dots

    def record(q, vectors, ids, impl="xla"):
        calls.append((q, ids.clone()))
        return inner(q, vectors, ids, impl=impl)

    tgraph.gather_dots = record
    try:
        idx.search_batch(qs, 10)
    finally:
        tgraph.gather_dots = inner
    require(len(calls) == 1 + idx.search_iters, f"graph: {len(calls)} gather calls a search")
    stats = gather_phase(idx, calls)

    gs = idx._graph_store
    nb = idx._nb_cap
    qt = torch.from_numpy(qs).to(DEV)

    def beam_once():
        entries = _probe_entries(qt, idx.centroids, idx.reps, e=idx.n_entries, metric="cosine")
        return tgraph.beam_search(qt, gs.vectors[:nb], gs.norms[:nb], gs.valid[:nb], entries,
                                  idx.neighbors, k=20, pool=idx.pool, expand=idx.expand,
                                  iters=idx.search_iters, metric="cosine")

    dev_ms = cuda_ms(beam_once, 10)
    b11_ms = (stats["gather_dots"]["ms"] * idx.search_iters
              + stats["gather_dots"]["entry"]["ms"])
    e2e_ms = med * 1e3
    log(f"[times] graph vector_search_batch B={BATCH} k=10 at {rows - n_del} rows: median "
        f"{e2e_ms:.3f} ms of 20 ({BATCH / med:.0f} queries/s); vector_search k=10 median "
        f"{single_t[49] * 1e3:.3f} ms, p99 {single_t[98] * 1e3:.3f} ms of 100; ingest "
        f"{rows / ingest_s:.0f} docs/s; optimize() {optimize_s:.2f} s")
    log(f"[times] graph breakdown of vector_search_batch B={BATCH}: end to end {e2e_ms:.3f} ms; "
        f"index.search_batch {index_ms:.3f} ms; device span of entry probe + beam (CUDA "
        f"events) {dev_ms:.3f} ms, of which B11 {idx.search_iters + 1} launches ~{b11_ms:.3f} "
        f"ms; readback, fresh scan, hit building and merge {index_ms - dev_ms:.3f} ms; planner "
        f"and results {e2e_ms - index_ms:.3f} ms; device busy share ~{dev_ms / e2e_ms:.2f}")
    phase_s = time.perf_counter() - t_phase
    log(f"[time] graph phase {phase_s:.1f} s (budget {GRAPH_BUDGET_S:.0f} s"
        f"{', over it' if phase_s > GRAPH_BUDGET_S else ''})")
    db.close()
    return launches, build_launches, group_launches, stats


# -- the embedded deployment: EmbeddedVectorDB, the file store, the device embedder ----------


class TextCorpus:
    """``n`` short sentences (6-14 words) over a synthetic vocabulary of
    ``EMBED_VOCAB`` words, chosen with Zipf-skewed frequencies (p ~ 1/r^1.1),
    so frequent words recur across documents; one document in 16 copies an
    earlier one with one word changed, so near-duplicate texts exist. Each
    carries ``topic`` (i % 16) for filters. Made from ``SEED``."""

    def __init__(self, n: int):
        rng = np.random.default_rng(SEED + 7)
        syl = np.array(["ka", "lo", "mi", "ne", "ru", "ta", "vo", "xe", "zi", "pa", "do",
                        "fe", "gu", "hi", "ja", "be", "so", "qu", "wy", "ol"])
        words = set()
        while len(words) < EMBED_VOCAB:
            words.add("".join(rng.choice(syl, int(rng.integers(2, 5)))))
        vocab = np.array(sorted(words))
        rng.shuffle(vocab)
        p = 1.0 / np.arange(1, EMBED_VOCAB + 1) ** 1.1
        lens = rng.integers(6, 15, n)
        picks = rng.choice(EMBED_VOCAB, size=int(lens.sum()), p=p / p.sum())
        ends = np.cumsum(lens)
        toks = [picks[e - ln:e].copy() for e, ln in zip(ends, lens)]
        for i in np.flatnonzero(rng.random(n) < 1 / 16):
            if i:
                src = toks[int(rng.integers(0, i))].copy()
                src[int(rng.integers(0, len(src)))] = int(rng.integers(0, EMBED_VOCAB))
                toks[i] = src
        self.texts = [" ".join(vocab[t]) for t in toks]
        self.n = n

    def docs(self):
        from grape_vector_db_tpu_torch import Document

        return [Document(id=f"doc{i}", content=t, metadata={"topic": i % 16})
                for i, t in enumerate(self.texts)]


def f16_ulps(a: np.ndarray, b: np.ndarray) -> float:
    """The largest |a - b| of two f16 arrays in units of the f16 spacing at
    the larger magnitude."""
    big = np.maximum(np.abs(a), np.abs(b)).astype(np.float16)
    return float((np.abs(a.astype(np.float32) - b.astype(np.float32))
                  / np.spacing(big).astype(np.float32)).max())


def index_oracle(idx, queries: np.ndarray, deep=64, keep=None):
    """Cosine top-``deep`` over the index's live rows (the stored bf16
    values as f32, gathered on the card), an f32 product on the card with
    TF32 off (not the port's kernels), among the rows whose document
    numbers ``keep`` passes where it is given: (values, doc numbers) for
    check_hits."""
    items = list(idx._id_to_slot.items())
    nums = np.array([int(i[3:]) for i, _ in items])
    x = idx.vectors[torch.tensor([s for _, s in items], device=idx.vectors.device)].float()
    q = torch.nn.functional.normalize(torch.from_numpy(queries).to(x.device), dim=1)
    s = (q @ x.T) / torch.linalg.vector_norm(x, dim=1).clamp(min=1e-12)[None, :]
    del x
    if keep is not None:
        s.masked_fill_(~torch.from_numpy(keep(nums)).to(s.device), float("-inf"))
    vals, rows = torch.topk(s, deep, dim=1)
    return vals.cpu().numpy(), nums[rows.cpu().numpy()]


def check_batch(label, hits, idx, queries):
    """``hits`` against the oracle over the index's rows, by the flat path's
    rule (ids as sets, near ties within TOL of the k-th score)."""
    o_vals, o_ids = index_oracle(idx, queries)
    check_hits(label, hits, o_vals, o_ids, 10)


def hit_arrays(hits):
    """(scores, doc numbers) of a batch of hits, for check_hits."""
    return (np.array([[p.score for p in row] for row in hits]),
            np.array([[int(p.id[3:]) for p in row] for row in hits]))


def same_rows(label, a, b, tol=1e-6):
    """Two batches of hits with the same ids in the same order and scores
    within ``tol``."""
    for r, (x, y) in enumerate(zip(a, b)):
        require([p.id for p in x] == [p.id for p in y], f"{label} q{r}: ids differ")
        d = max((abs(p.score - q.score) for p, q in zip(x, y)), default=0.0)
        require(d <= tol, f"{label} q{r}: scores differ by {d}")


def embedded_path():
    """The embedded deployment at the default configuration on the card:
    ``EmbeddedVectorDB`` over a file store in a temporary directory,
    ``embedding.provider = "device"`` (D = 768, cosine, bf16 flat, 32,768
    buckets, 256 features, chunk 1024). Projection check, pipelined
    device-direct ingest of ``EMBED_DOCS`` text documents, the stored rows
    and the card's embedding against the CPU port's, ``search_documents``,
    single queries from 32 threads through the batching executor, the B = 256
    batch through B1 against the oracle and B1 against its plain version on
    the index's plane, filters, the enterprise wrappers,
    index snapshot, backup and restore, close and reopen at the default
    startup timeout. Returns B1's entry for this path: the batch call's
    launches and ``index_plane_check``'s figures."""
    import tempfile
    import threading

    from grape_vector_db_tpu_torch import (Condition, Document, EmbeddedConfig,
                                           EmbeddedVectorDB, Filter, SearchRequest,
                                           VectorDbConfig)
    from grape_vector_db_tpu_torch.errors import AuthorizationError
    from grape_vector_db_tpu_torch.services.device_embedder import DeviceHashEmbedder
    from grape_vector_db_tpu_torch.services.enterprise import Role
    from grape_vector_db_tpu_torch.storage import file as tfile
    from grape_vector_db_tpu_torch.utils import jax_random

    t_phase = time.perf_counter()
    card = CARD
    codec = "zstandard" if tfile._zstandard() is not None else "zlib (zstandard does not import)"
    corpus = TextCorpus(EMBED_DOCS)
    docs = corpus.docs()
    tmp = tempfile.TemporaryDirectory(prefix="gvdb_embedded_")
    cfg = EmbeddedConfig(data_dir=os.path.join(tmp.name, "data"), db=VectorDbConfig())
    cfg.db.embedding.provider = "device"
    t0 = time.perf_counter()
    edb = EmbeddedVectorDB(cfg, device=DEV)
    db = edb.db
    emb = getattr(db.embedder, "inner", db.embedder)
    require(isinstance(emb, DeviceHashEmbedder) and emb.device.type == torch.device(DEV).type,
            f"the db's embedder is {type(emb).__name__} on {getattr(emb, 'device', None)}")
    log(f"[embedded] EmbeddedVectorDB on {DEV} ({card}): index {db.index.kind}, "
        f"{db.index.storage_dtype}, D {db.config.vector_dimension}, {emb._buckets} buckets, "
        f"{emb._max_features} features, chunk {emb._chunk}; store {type(db.store).__name__} "
        f"compressed with {codec}; {corpus.n} documents over {EMBED_VOCAB} words; "
        f"startup_timeout_s {cfg.startup_timeout_s:g} (the default); "
        f"open {time.perf_counter() - t0:.2f} s")

    # 1. the projection, checked against the numpy stream on 4,096 entries
    t0 = time.perf_counter()
    proj = emb._projection()
    torch.cuda.synchronize()
    proj_s = time.perf_counter() - t0
    gen = np.random.default_rng(SEED + 8)
    flat_idx = gen.choice(proj.numel(), 4096, replace=False)
    table = jax_random.normal_bf16_table().view(torch.int16).numpy()
    want = table[jax_random.random_bits8(jax_random.prng_key(emb._seed), flat_idx) >> 1]
    got = proj.reshape(-1)[torch.from_numpy(flat_idx).to(proj.device)].view(
        torch.int16).cpu().numpy()
    require(np.array_equal(got, want), "the projection differs from the numpy stream")
    log(f"[embedded] projection [{emb._buckets}, {emb._dim}] bf16 built in {proj_s:.2f} s; "
        f"4096 sampled entries bit-equal to the numpy threefry stream")

    # the embedder alone: featurization (host) and the device step, apart
    sample = corpus.texts[:16384]
    t0 = time.perf_counter()
    idx_f, val_f = emb._featurize(sample)
    feat_s = time.perf_counter() - t0
    emb._embed_chunk(idx_f[:emb._chunk], val_f[:emb._chunk], proj)     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, len(sample), emb._chunk):
        emb._embed_chunk(idx_f[lo:lo + emb._chunk], val_f[lo:lo + emb._chunk], proj)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb.embed_array(sample)
    whole_s = time.perf_counter() - t0
    log(f"[times] embedder on {card}: {len(sample)} texts: featurization {feat_s:.3f} s "
        f"({len(sample) / feat_s:.0f} texts/s, host), device step {step_s:.3f} s "
        f"({len(sample) / step_s:.0f} texts/s: scatter-add, bf16 product with f32 out, "
        f"normalize, f16 copy), embed_array end to end {whole_s:.3f} s "
        f"({len(sample) / whole_s:.0f} texts/s)")

    # 2. pipelined device-direct ingest
    calls = {"add_batch_device": 0, "add_batch": 0}
    for name in calls:
        fn = getattr(db.index, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        setattr(db.index, name, counted)
    t0 = time.perf_counter()
    ids = db.add_documents_pipelined(docs, batch_size=4096, inflight=2)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    for name in calls:
        delattr(db.index, name)
    n_batches = -(-corpus.n // 4096)
    require(ids == [d.id for d in docs], "pipelined ingest returned other ids")
    require(calls == {"add_batch_device": n_batches, "add_batch": 0},
            f"ingest took {calls}, wanted every one of {n_batches} batches device-direct")
    require(len(db.index) == corpus.n and db.store.count() == corpus.n,
            f"{len(db.index)} rows in the index, {db.store.count()} in the store")
    log(f"[times] embedded ingest: {corpus.n} documents in {ingest_s:.2f} s "
        f"({corpus.n / ingest_s:.0f} docs/s, add_documents_pipelined batch 4096, inflight 2; "
        f"{calls['add_batch_device']} batches through add_batch_device, none through "
        f"add_batch); capacity {db.index.capacity}")

    # 3. the stored f16 rows of 512 documents against embed_array of their texts
    pick = gen.choice(corpus.n, 512, replace=False)
    ref = emb.embed_array([corpus.texts[i] for i in pick]).astype(np.float16)
    stored = np.stack([np.asarray(db.store.get(f"doc{i}").embedding, np.float32)
                       for i in pick]).astype(np.float16)
    ulps = f16_ulps(stored, ref)
    require(ulps <= 1.0, f"stored rows differ from embed_array by {ulps} f16 ulps")
    log(f"[embedded] 512 stored f16 rows against embed_array of their texts: within "
        f"{ulps:.0f} f16 ulp (the batch's product may sum in another order)")

    # 4. the card's f32 embedding of 256 texts against the CPU port's
    texts256 = [corpus.texts[i] for i in pick[:256]]
    cpu_emb = DeviceHashEmbedder(device="cpu")
    (c32, _), = [c for c in emb.embed_ingest(texts256)[0]]
    (h32, _), = [c for c in cpu_emb.embed_ingest(texts256)[0]]
    err = (c32[:256].cpu() - h32[:256]).abs().max().item()
    require(err <= EMBED_TOL, f"card embedding differs from the CPU port's by {err}")
    log(f"[embedded] 256 texts: the card's f32 rows within {err:.3g} of the CPU port's "
        f"(tolerance {EMBED_TOL}: the same bf16 products summed in another order)")

    # 5. search_documents finds each text's own document first
    by_text = {}
    for i, t in enumerate(corpus.texts):
        by_text.setdefault(t, []).append(f"doc{i}")
    t0 = time.perf_counter()
    dup = 0
    for i in pick[:64]:
        res = db.search_documents(corpus.texts[i], limit=5)
        top = res[0].document.id if res else None
        if top != f"doc{i}":
            require(top in by_text[corpus.texts[i]],
                    f"search_documents for doc{i} returned {top} first")
            dup += 1
    sd_s = (time.perf_counter() - t0) / 64
    log(f"[embedded] search_documents on 64 sampled texts: own document first "
        f"{64 - dup}/64, a duplicate of its text first {dup}/64; {sd_s * 1e3:.1f} ms a call")

    # 6. single queries from 32 threads through the batching executor
    qv = np.stack([np.asarray(db.store.get(f"doc{i}").embedding, np.float32)
                   for i in pick[:300]])
    lat = [0.0] * 300
    top1 = [None] * 300

    def worker(w):
        for j in range(w, 300, 32):
            t1 = time.perf_counter()
            row = edb.vector_search_one(qv[j], 10)
            lat[j] = time.perf_counter() - t1
            top1[j] = row[0] if row else None

    before = edb.executor.batches_run
    threads = [threading.Thread(target=worker, args=(w,)) for w in range(32)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "a vector_search_one thread hung")
    for j, i in enumerate(pick[:300]):
        require(top1[j] is not None and top1[j].score > 0.99 and
                top1[j].id in by_text[corpus.texts[i]],
                f"vector_search_one of doc{i}'s row returned {top1[j]}")
    batches = edb.executor.batches_run - before
    p50, p99 = np.percentile(np.array(lat) * 1e3, [50, 99])
    log(f"[times] embedded vector_search_one, 32 threads, 300 calls: p50 {p50:.3f} ms, "
        f"p99 {p99:.3f} ms, {300 / wall:.0f} queries/s; {batches} executor batches "
        f"(mean {300 / max(batches, 1):.1f} queries)")

    # 7. the B = 256 batch through B1, against the oracle
    queries = qv[:EMBED_BATCH] + 0.02 * gen.standard_normal(
        (EMBED_BATCH, qv.shape[1])).astype(np.float32)
    reset_counts()
    batch = db.vector_search_batch(queries, 10)
    torch.cuda.synchronize()
    counts = read_counts()
    require(counts["segmax4"] > 0, f"the B={EMBED_BATCH} batch never launched segmax4: {counts}")
    check_batch(f"embedded batch B={EMBED_BATCH}", batch, db.index, queries)
    b1 = index_plane_check("embedded", "segmax4", db.index, queries)
    b1["launches"] = counts["segmax4"]
    med = timed(lambda: db.vector_search_batch(queries, 10))
    log(f"[times] embedded vector_search_batch B={EMBED_BATCH} k=10 at {corpus.n} documents: "
        f"median {med * 1e3:.3f} ms of 20 ({EMBED_BATCH / med:.0f} queries/s); launches "
        f"{ {k: v for k, v in counts.items() if v} }; agrees with the oracle (tolerance {TOL})")

    # 8. filters, counting and listing
    f3 = Filter(must=[Condition("topic", "eq", 3)])
    want_n = len(range(3, corpus.n, 16))
    fhits = edb.vector_search(SearchRequest(vector=queries[0].tolist(), limit=10, filter=f3))
    require(len(fhits) == 10 and all(int(p.id[3:]) % 16 == 3 for p in fhits),
            "a filtered search broke its filter")
    require(db.count_documents(f3) == want_n and db.count_documents() == corpus.n,
            "count_documents disagrees")
    page = db.list_documents(offset=100, limit=50, filter=f3)
    require(len(page) == 50 and all(d.metadata["topic"] == 3 for d in page),
            "list_documents broke its filter")
    require(len(db.list_documents(offset=0, limit=200)) == 200, "list_documents short")
    log(f"[embedded] filtered search, count_documents ({want_n} of {corpus.n}) and "
        f"list_documents obey the filter")

    # 9. the enterprise wrappers
    auth = db.enable_enterprise()
    reader = auth.create_api_key("reader", Role.READ_ONLY_USER)
    res = db.search_with_auth(reader.key, SearchRequest(vector=qv[0].tolist(), limit=5))
    require(bool(res) and res[0].document.id in by_text[corpus.texts[pick[0]]],
            "a READ_DATA key's search failed")
    try:
        db.add_documents_with_auth(reader.key, [Document(id="denied", content="no write")])
        require(False, "a key without WRITE_DATA wrote")
    except AuthorizationError:
        pass
    log("[embedded] enterprise: a READ_DATA key searches, a key without WRITE_DATA "
        "cannot write")

    # 10. persistence: index snapshot, backup and restore, close, reopen
    snap = os.path.join(tmp.name, "index.snap")
    t0 = time.perf_counter()
    info = db.save_index(snap)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db.load_index(snap)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    same_rows("after load_index", db.vector_search_batch(queries, 10), batch)
    bak = os.path.join(tmp.name, "backup.gvdb")
    t0 = time.perf_counter()
    db.create_backup(bak)
    backup_s = time.perf_counter() - t0
    db.batch_delete_documents([f"doc{i}" for i in range(1000)])
    require(db.count_documents() == corpus.n - 1000, "the delete before restore")
    t0 = time.perf_counter()
    db.restore_backup(bak)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require(db.count_documents() == corpus.n and len(db.index) == corpus.n,
            "restore_backup did not bring the documents back")
    restored = db.vector_search_batch(queries, 10)
    check_batch("after restore_backup", restored, db.index, queries)
    check_hits("after restore_backup against before", restored, *hit_arrays(batch), 10)
    edb.close()
    require(edb.state.value == "closed", f"state after close: {edb.state}")
    t0 = time.perf_counter()
    edb = EmbeddedVectorDB(cfg, device=DEV)
    torch.cuda.synchronize()
    reopen_s = time.perf_counter() - t0
    db = edb.db
    require(db.count_documents() == corpus.n and len(db.index) == corpus.n,
            f"reopened with {db.count_documents()} documents, {len(db.index)} rows")
    reopened = db.vector_search_batch(queries, 10)
    check_batch("after reopen", reopened, db.index, queries)
    check_hits("after reopen against restore", reopened, *hit_arrays(restored), 10)
    health = edb.health_check()
    require(health.status.value == "healthy", f"health after reopen: {health}")
    edb.close()
    tmp.cleanup()
    log(f"[times] embedded persistence on {card} ({codec}): save_index {save_s:.2f} s "
        f"({info['bytes'] / 1e6:.1f} MB), load_index {load_s:.2f} s, create_backup "
        f"{backup_s:.2f} s, restore_backup {restore_s:.2f} s (rebuild included), reopen and "
        f"rebuild {reopen_s:.2f} s (startup_timeout_s {cfg.startup_timeout_s:g}, the "
        f"default); results equal after load_index, within the oracle's "
        f"rule after restore and reopen (the rows come back from the store's f16 copy); "
        f"health {health.status.value}")
    phase_s = time.perf_counter() - t_phase
    log(f"[time] embedded phase {phase_s:.1f} s (budget {EMBED_BUDGET_S:.0f} s"
        f"{', over it' if phase_s > EMBED_BUDGET_S else ''})")
    return b1


def index_plane_check(label, name, idx, queries):
    """B1 (``segmax4``) or B2 (``segmax2``) against its plain version on an
    index's own plane: the queries prepared as the flat path prepares them,
    the index's rows (its whole capacity) and their cosine weight plane.
    Also times both in turns. Launches here are not counted as a path's."""
    from grape_vector_db_tpu_torch.ops import segmax
    from grape_vector_db_tpu_torch.ops.distance import prepare_queries

    topj = 4 if name == "segmax4" else 2
    kern = segmax.segmax4_scores if topj == 4 else segmax.segmax2_scores
    plain = segmax.segmax4_scores_ref if topj == 4 else segmax.segmax2_scores_ref
    v = idx.vectors
    n, d = v.shape
    b = queries.shape[0]
    q = prepare_queries(torch.from_numpy(queries).to(v.device), "cosine")
    w = segmax.make_weight_plane(idx.norms, idx.valid, "cosine")
    got = kern(q, v, w)
    torch.cuda.synchronize()
    want = plain(q, v, w)
    if topj == 2:   # (m1, i1, m2) -> values first
        got, want = (got[0], got[2], got[1]), (want[0], want[2], want[1])
    err = plane_check(f"{name} ({label} index) [{b},{d}] x [{n},{d}] bf16", got, want, topj)
    (k1, k2), (p1, p2) = in_turns(lambda: kern(q, v, w), lambda: plain(q, v, w))
    nbytes = n * d * 2 + n * 4 + b * d * 2 + (2 * topj - 1) * b * (n // 32) * 4
    lim = bound(nbytes, 2.0 * b * n * d)
    log(f"[times] {name} on the {label} index's plane ({CARD}): kernel {(k1 + k2) / 2:.4f} ms "
        f"({k1:.4f} / {k2:.4f}), plain {(p1 + p2) / 2:.4f} ms, bound {lim['bound_ms']:.4f} ms "
        f"({lim['bound_by']})")
    return {"shape": f"q [{b},{d}] x [{n},{d}] bf16", "max_abs_err": err,
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, **lim}


# -- the single-node server ---------------------------------------------------------

SERVER_BUDGET_S = 150.0   # server_path and cli_path together
SERVER_THREADS = 32       # client threads, as many RPCs in flight
SERVER_QUERIES = 320      # distinct query vectors: half near stored rows, half anywhere
NEW_ROWS = 8192           # rows upserted over gRPC (16 RPCs of 512)
REST_ROWS = 1024          # rows posted over REST (4 calls of 256)
SERVED_DELETES = 1024
CLI_ROWS = 1 << 14        # rows the serve subprocess takes over gRPC (16 RPCs of 1,024; cut
                          # from 65,536 to make room in the limit for the sharded phase)
# the keys each CLI subcommand prints, as the JAX package's CLI prints them
# (tests/test_torch_bench_cli.py holds the two CLIs to one set)
CLI_KEYS = {
    "benchmark": {"insert_docs", "insert_s", "insert_qps", "searches", "avg_ms", "p95_ms",
                  "search_qps"},
    "performance-test": {"batch_insert_s", "text_searches", "text_search_avg_ms"},
    "simple-performance-test": {"total_queries", "avg_ms", "p95_ms", "p99_ms", "qps"},
    "concurrent-insert-test": {"batch_50_s", "sequential_50_s", "speedup", "target_met"},
    "storage-analysis": {"with_vectors_s", "without_vectors_s", "with_vectors_bytes",
                         "without_vectors_bytes"},
    "fusion-benchmark": {"name", "precision@10", "recall@10", "ndcg@10", "p95_ms", "qps"},
}


def in_group3(nums: np.ndarray) -> np.ndarray:
    """The rows the server phase's filter ``g = 3`` keeps: group 3 of the
    flat corpus, whose new rows carry the same groups (number mod 10)."""
    return nums % 10 == 3


class RestHit:
    """A REST search result as check_hits reads one."""

    def __init__(self, r):
        self.id, self.score, self.payload = r["id"], r["score"], r.get("payload")


def rest_call(base, method, path, body=None):
    """(status, decoded JSON or text) of one REST request."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw = resp.read()
            kind = resp.headers.get("Content-Type", "")
            return resp.status, json.loads(raw) if "json" in kind else raw.decode()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def metric_value(text: str, name: str) -> float:
    """A gauge's value from Prometheus text, or -1 where it is absent."""
    for line in text.splitlines():
        if line.startswith(f"grape_vector_db_{name} "):
            return float(line.split()[-1])
    return -1.0


def on_threads(fn, items, threads=SERVER_THREADS):
    """fn(item) for every item from ``threads`` threads: (results, per-call
    seconds, wall seconds)."""
    def timed_call(item):
        t0 = time.perf_counter()
        out = fn(item)
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        done = list(pool.map(timed_call, items))
    return [r for r, _ in done], [t for _, t in done], time.perf_counter() - t0


def pct_ms(secs):
    p50, p99 = np.percentile(np.array(secs) * 1e3, [50, 99])
    return f"p50 {p50:.3f} ms, p99 {p99:.3f} ms"


def server_path(db):
    """The single-node server over the flat phase's database (1,048,576 x 768
    bf16, cosine, 1,000 deleted): ``build_grpc_server`` and ``RestServer``
    on 127.0.0.1, port 0. Unfiltered gRPC traffic from 32 threads through the
    micro-batcher at k = 10 (B1) and k = 3 (B2); filtered and payload RPCs,
    which skip it; REST searches; upserts over both protocols (with searches
    in flight), each new row's own vector back first, deletes, lookups,
    counts, health and metrics; one batch under ``profile_to``. Every answer
    against the oracle over the index's rows. The host time of each
    ``vector_search_batch`` call the batcher makes under that load is held
    beside the same call's time with no traffic. Then B1 and B2 against
    their plain versions on the served plane at the batcher's largest batch.
    Returns B1's and B2's entries for this path."""
    import tempfile

    from grape_vector_db_tpu_torch.ops.distance import scored_topk
    from grape_vector_db_tpu_torch.server import grpc_server as gsrv
    from grape_vector_db_tpu_torch.server.proto import vector_db_pb2 as pb
    from grape_vector_db_tpu_torch.server.rest import RestServer
    from grape_vector_db_tpu_torch.utils.tracing import profile_to, trace_span

    t_phase = time.perf_counter()
    idx = db.index
    rng = np.random.default_rng(SEED + 20)
    deleted = [n for n in range(N_ROWS) if f"doc{n}" not in idx._id_to_slot]
    alive = np.setdiff1d(np.arange(N_ROWS), deleted)
    near = rng.choice(alive, SERVER_QUERIES // 2, replace=False)
    queries = np.concatenate([
        np.stack([np.asarray(db.get_document(f"doc{r}").vector, np.float32) for r in near])
        + 0.5 * rng.standard_normal((SERVER_QUERIES // 2, DIM), dtype=np.float32),
        rng.standard_normal((SERVER_QUERIES // 2, DIM), dtype=np.float32)])
    qlists = queries.astype(float).tolist()
    o_vals, o_ids = index_oracle(idx, queries)
    f_vals, f_ids = index_oracle(idx, queries, keep=in_group3)

    calls = []   # host seconds of each engine.vector_search_batch call
    search_batch = db.engine.vector_search_batch

    def timed_batch(q, k):
        t0 = time.perf_counter()
        try:
            return search_batch(q, k)
        finally:
            calls.append(time.perf_counter() - t0)

    # the servicer hands this instance attribute to its batcher when it is built
    db.engine.vector_search_batch = timed_batch
    server, port, servicer = gsrv.build_grpc_server(db, port=0, max_workers=SERVER_THREADS)
    server.start()
    rest = RestServer(db, host="127.0.0.1", port=0)
    host, rport = rest.start()
    base = f"http://{host}:{rport}"
    client = gsrv.VectorDbClient(f"127.0.0.1:{port}", timeout_s=120.0)
    batcher = servicer.batcher
    log(f"[server] gRPC :{port} and REST {host}:{rport} over the flat phase's database on "
        f"{DEV} ({CARD}): {len(idx)} rows at capacity {idx.capacity}; micro-batcher "
        f"max_batch {batcher.max_batch}, wait {batcher.max_wait_s * 1e3:g} ms, pad_to "
        f"{batcher.pad_to}; grpc {__import__('grpc').__version__}, protobuf "
        f"{__import__('google.protobuf').protobuf.__version__}")

    def search(args):
        j, k = args
        r = client.call("SearchVectors", pb.SearchVectorsRequest(
            query=pb.Vector(values=qlists[j]), limit=k))
        require(not r.error, f"SearchVectors: {r.error}")
        return r

    try:
        reset_counts()
        # 1. unfiltered traffic through the micro-batcher: k = 10 (B1), k = 3 (B2)
        hits10 = []
        for k, n_rpc in ((10, 640), (3, 320)):
            b0, q0, c0 = batcher.batches_run, batcher.queries_run, len(calls)
            jobs = [(j % SERVER_QUERIES, k) for j in range(n_rpc)]
            res, secs, wall = on_threads(search, jobs)
            for (j, _), r in zip(jobs, res):
                check_hits(f"gRPC k={k} q{j}", [r.results], o_vals[j:j + 1], o_ids[j:j + 1], k)
            hits10 += [h.id for r in res for h in r.results] if k == 10 else []
            nb = batcher.batches_run - b0
            log(f"[times] server gRPC SearchVectors k={k}, {SERVER_THREADS} threads, {n_rpc} "
                f"RPCs: {pct_ms(secs)}, {n_rpc / wall:.0f} RPC/s; {nb} batches, avg_batch "
                f"{(batcher.queries_run - q0) / max(nb, 1):.2f}; the batcher's "
                f"vector_search_batch calls {pct_ms(calls[c0:])}; all agree with the oracle")
        log(f"[server] batcher.stats() {batcher.stats()}")
        # the RPCs' launches so far; the timings below launch B1 outside them
        served = read_counts()
        idle = []
        for _ in range(20):
            t0 = time.perf_counter()
            search_batch(rng.standard_normal((16, DIM), dtype=np.float32), 10)
            idle.append(time.perf_counter() - t0)
        qt = torch.from_numpy(queries[:batcher.max_batch]).to(DEV)
        span = cuda_ms(lambda: scored_topk(qt, idx.vectors, idx.norms, idx.valid, 10,
                                           metric=idx.metric,
                                           chunk=min(65536, idx.capacity),
                                           mode=idx.search_mode), 20)
        reset_counts()
        log(f"[times] server vector_search_batch with no traffic, B=16 k=10, 20 calls: "
            f"{pct_ms(idle)}")
        log(f"[times] server device span of one batch B={batcher.max_batch} k=10 "
            f"(scored_topk: B1 and phase 2; CUDA events, mean of 20): {span:.3f} ms")

        # 2. filtered and payload RPCs, which skip the batcher. The engine
        # caches results by query vector and filter, so each timed call from
        # here on sends a vector that no call before it sent with its filter
        b0 = batcher.batches_run

        def filtered(j):
            return client.search(qlists[j], limit=10, filter_sql="g = 3")

        res, secs, _ = on_threads(filtered, range(64))
        for j, r in enumerate(res):
            require(not r.error and all(h.payload["g"] == "3" for h in r.results),
                    f"filtered RPC q{j} broke its filter: {r.error}")
            check_hits(f"gRPC filtered q{j}", [r.results], f_vals[j:j + 1], f_ids[j:j + 1], 10)
        log(f"[times] server gRPC filtered (g = 3) SearchVectors, 64 RPCs: {pct_ms(secs)}")
        res, secs, _ = on_threads(lambda j: client.search(qlists[j], limit=10), range(64, 96))
        for j, r in zip(range(64, 96), res):
            check_hits(f"gRPC with_payload q{j}", [r.results], o_vals[j:j + 1], o_ids[j:j + 1],
                       10)
            require(all(h.payload["g"] == str(int(h.id[3:]) % 10) for h in r.results),
                    f"with_payload q{j}: a payload differs from its row's")
        require(batcher.batches_run == b0, "a filtered or payload RPC went through the batcher")
        log(f"[times] server gRPC with_payload SearchVectors, 32 RPCs: {pct_ms(secs)}; "
            "filters and payloads obeyed, none through the batcher")

        # 3. REST: sequential searches, then filtered ones
        secs = []
        for j in range(96, 296):
            t0 = time.perf_counter()
            code, out = rest_call(base, "POST", "/api/v1/search",
                                  {"mode": "vector", "vector": qlists[j], "limit": 10})
            secs.append(time.perf_counter() - t0)
            require(code == 200, f"REST search: {code} {out}")
            check_hits(f"REST q{j}", [[RestHit(r) for r in out["results"]]], o_vals[j:j + 1],
                       o_ids[j:j + 1], 10)
        log(f"[times] server REST POST /api/v1/search k=10, 200 sequential: {pct_ms(secs)}")
        secs = []
        for j in range(64, 96):
            t0 = time.perf_counter()
            code, out = rest_call(base, "POST", "/api/v1/search",
                                  {"vector": qlists[j], "limit": 10, "filter_sql": "g = 3"})
            secs.append(time.perf_counter() - t0)
            hits = [RestHit(r) for r in out["results"]]
            require(code == 200 and all(h.payload["g"] == 3 for h in hits),
                    f"REST filtered q{j} broke its filter")
            check_hits(f"REST filtered q{j}", [hits], f_vals[j:j + 1], f_ids[j:j + 1], 10)
        log(f"[times] server REST filtered (g = 3) search, 32 sequential: {pct_ms(secs)}; "
            "all obey the filter and agree with the oracle")

        # 4. writes: upserts over both protocols with searches in flight
        new = rng.standard_normal((NEW_ROWS + REST_ROWS, DIM), dtype=np.float32)
        first = N_ROWS + 1   # past every number the flat corpus used

        def upsert(c):
            lo = c * 512
            pts = [pb.Point(id=f"doc{first + i}", vector=pb.Vector(values=new[i]),
                            payload={"g": str((first + i) % 10)}) for i in range(lo, lo + 512)]
            r = client.call("UpsertVector", pb.UpsertVectorRequest(points=pts))
            require(r.upserted == 512 and not r.error, f"UpsertVector: {r.error}")

        with concurrent.futures.ThreadPoolExecutor(8) as readers:
            during = [readers.submit(search, (j, 10)) for j in range(256)]
            _, secs, wall = on_threads(upsert, range(NEW_ROWS // 512), threads=4)
            for f in during:
                r = f.result()
                sc = [h.score for h in r.results]
                require(len(sc) == 10 and np.isfinite(sc).all() and sc == sorted(sc, reverse=True),
                        "a search during the upserts returned a malformed answer")
        log(f"[times] server gRPC UpsertVector: {NEW_ROWS} rows in {NEW_ROWS // 512} RPCs of 512 "
            f"from 4 threads, 256 searches in flight: {wall:.2f} s ({NEW_ROWS / wall:.0f} "
            f"rows/s), per RPC {pct_ms(secs)}")
        t0 = time.perf_counter()
        per = REST_ROWS // 4
        for lo in range(NEW_ROWS, NEW_ROWS + REST_ROWS, per):
            code, out = rest_call(base, "POST", "/api/v1/vectors", {"points": [
                {"id": f"doc{first + i}", "vector": new[i].tolist(),
                 "metadata": {"g": (first + i) % 10}} for i in range(lo, lo + per)]})
            require(code == 200 and out["upserted"] == per, f"REST upsert: {code} {out}")
        rest_s = time.perf_counter() - t0
        log(f"[times] server REST POST /api/v1/vectors: {REST_ROWS} rows in 4 calls of {per}: "
            f"{rest_s:.2f} s ({REST_ROWS / rest_s:.0f} rows/s); capacity now {idx.capacity}")
        own = new.astype(float).tolist()

        def own_first(i):
            r = client.call("SearchVectors", pb.SearchVectorsRequest(
                query=pb.Vector(values=own[i]), limit=10))
            return r.results[0].id if r.results else None, r.results[0].score

        res, secs, wall = on_threads(own_first, range(NEW_ROWS + REST_ROWS))
        for i, (top, score) in enumerate(res):
            require(top == f"doc{first + i}" and score > 0.99,
                    f"new row doc{first + i}: its own vector returned {top} ({score}) first")
        log(f"[server] each of the {NEW_ROWS + REST_ROWS} new rows' own vectors returns it "
            f"first ({len(res)} RPCs, {pct_ms(secs)}, {len(res) / wall:.0f} RPC/s)")
        for i in [*range(0, NEW_ROWS, NEW_ROWS // 8), *range(NEW_ROWS, NEW_ROWS + REST_ROWS,
                                                               REST_ROWS // 8)]:
            g = client.call("GetVector", pb.GetVectorRequest(id=f"doc{first + i}"))
            code, out = rest_call(base, "GET", f"/api/v1/vectors/doc{first + i}")
            require(g.found and code == 200, f"doc{first + i} not found ({code})")
            require(np.array_equal(np.asarray(g.point.vector.values, np.float32), new[i])
                    and np.array_equal(np.asarray(out["vector"], np.float32), new[i]),
                    f"doc{first + i}: GetVector or GET /api/v1/vectors gave another vector")
        # rows answered in step 1: no write since has removed any of them
        doomed = list(dict.fromkeys(hits10))[:SERVED_DELETES]
        require(len(doomed) == SERVED_DELETES, f"only {len(doomed)} distinct hits to delete")
        r = client.call("DeleteVector", pb.DeleteVectorRequest(ids=doomed))
        require(r.deleted == SERVED_DELETES and not r.error, f"DeleteVector: {r.deleted} {r.error}")
        want_n = N_ROWS - len(deleted) + NEW_ROWS + REST_ROWS - SERVED_DELETES
        st = client.call("GetStats", pb.GetStatsRequest())
        require(st.document_count == want_n and st.index_size == want_n,
                f"GetStats {st.document_count} / {st.index_size}, wanted {want_n}")
        a_vals, a_ids = index_oracle(idx, queries)
        af_vals, af_ids = index_oracle(idx, queries, keep=in_group3)
        gone = frozenset(int(i[3:]) for i in doomed)
        res, _, _ = on_threads(search, [(j, 10) for j in range(SERVER_QUERIES)])
        for j, r in enumerate(res):
            check_hits(f"gRPC after writes q{j}", [r.results], a_vals[j:j + 1], a_ids[j:j + 1], 10,
                       exclude=gone)
        for j in range(16):
            r = client.search(qlists[j], limit=10, filter_sql="g = 3")
            check_hits(f"gRPC filtered after writes q{j}", [r.results], af_vals[j:j + 1],
                       af_ids[j:j + 1], 10, exclude=gone)
        log(f"[server] after {NEW_ROWS + REST_ROWS} upserts and {SERVED_DELETES} deletes: GetStats "
            f"counts {want_n} exactly; GetVector and GET /api/v1/vectors give back the vectors "
            f"sent; {SERVER_QUERIES} unfiltered and 16 filtered answers agree with the oracle "
            "and hold no deleted id")

        # 5. health and metrics
        code, health = rest_call(base, "GET", "/health")
        require(code == 200 and health["status"] == "healthy", f"/health: {code} {health}")
        g_hbm = metric_value(client.call("GetMetrics", pb.GetMetricsRequest()).prometheus_text,
                             "hbm_bytes_in_use")
        code, text = rest_call(base, "GET", "/metrics")
        r_hbm = metric_value(text, "hbm_bytes_in_use")
        require(g_hbm > 0 and r_hbm > 0, f"hbm_bytes_in_use {g_hbm} / {r_hbm}")
        log(f"[server] /health 200 ({health['document_count']} documents, index consistent "
            f"{health['index_consistent']}); hbm_bytes_in_use {g_hbm:.0f} (GetMetrics), "
            f"{r_hbm:.0f} (/metrics)")

        # 6. one batch of gRPC searches under the profiler
        with tempfile.TemporaryDirectory(prefix="gvdb_trace_") as tdir:
            with profile_to(tdir):
                with trace_span("server.grpc_batch"):
                    on_threads(search, [(j, 10) for j in range(64)])
            (path,) = [os.path.join(tdir, f) for f in os.listdir(tdir)]
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        kern = sorted(n for n in names if "segmax_max_kernel" in n)
        require("server.grpc_batch" in names and kern,
                f"the trace lacks the span or segmax_max_kernel ({len(names)} names)")
        span_us = max(e.get("dur", 0) for e in events if e.get("name") == "server.grpc_batch")
        busy_us = sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel")
        log(f"[server] profile_to over 64 RPCs: {len(events)} trace events, the span "
            f"server.grpc_batch and {kern[0][:60]} named in the Chrome trace")
        log(f"[times] server traced batch of 64 RPCs: span {span_us / 1e3:.3f} ms, kernels "
            f"{busy_us / 1e3:.3f} ms on the device (busy share {busy_us / span_us:.3f})")
        torch.cuda.synchronize()
        counts = {name: n + served.get(name, 0) for name, n in read_counts().items()}
    finally:
        client.close()
        rest.stop()
        server.stop(grace=1)
        del db.engine.vector_search_batch
    for name in ("segmax4", "segmax2"):
        require(counts[name] > 0, f"the server path never launched {name}: {counts}")
    log(f"[server] kernel launches on the server path: "
        f"{ {k: v for k, v in counts.items() if v} }")

    # 7. B1 and B2 at the server's largest batch, on the served plane
    out = {}
    for name in ("segmax4", "segmax2"):
        out[name] = index_plane_check("served", name, idx, queries[:batcher.max_batch])
        out[name]["launches"] = counts[name]
    batcher.close()
    db.close()
    phase_s = time.perf_counter() - t_phase
    log(f"[time] server phase {phase_s:.1f} s")
    return out, phase_s


def cli_path():
    """The CLI on the card: ``python3 -m grape_vector_db_tpu_torch.cli serve``
    as a subprocess at the default device and configuration, fed over gRPC
    and searched against the numpy oracle, its /metrics read, stopped by an
    interrupt; then every other subcommand in process at its defaults, and
    ``tune`` on the served data directory. Returns the phase's seconds."""
    import contextlib
    import io
    import queue
    import signal
    import tempfile
    import threading

    from grape_vector_db_tpu_torch import cli
    from grape_vector_db_tpu_torch.server import grpc_server as gsrv
    from grape_vector_db_tpu_torch.server.proto import vector_db_pb2 as pb

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory(prefix="gvdb_serve_")
    data = os.path.join(tmp.name, "data")
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "grape_vector_db_tpu_torch.cli", "serve", "--host", "127.0.0.1",
         "--grpc-port", "0", "--rest-port", "0", "--data-dir", data],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    seen = []
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    try:
        m = None
        deadline = time.monotonic() + 180
        while m is None and time.monotonic() < deadline and proc.poll() is None:
            try:
                seen.append(lines.get(timeout=1.0))
            except queue.Empty:
                continue
            m = re.search(r"serving: grpc=:(\d+) rest=([\d.]+):(\d+)", seen[-1])
        require(m is not None, f"serve printed no banner in time: {''.join(seen)[-3000:]}")
        boot_s = time.perf_counter() - t_phase
        client = gsrv.VectorDbClient(f"127.0.0.1:{m[1]}", timeout_s=120.0)
        base = f"http://{m[2]}:{m[3]}"
        x = np.random.default_rng(SEED + 30).standard_normal((CLI_ROWS, DIM), dtype=np.float32)

        def upsert(lo):
            r = client.upsert_points([pb.Point(id=f"doc{i}", vector=pb.Vector(values=x[i]),
                                               payload={"g": str(i % 10)})
                                      for i in range(lo, lo + 1024)])
            require(r.upserted == 1024 and not r.error, f"UpsertVector: {r.error}")

        # four client threads, so that building the next request overlaps the server's work
        _, _, ingest_s = on_threads(upsert, range(0, CLI_ROWS, 1024), threads=4)
        gen = np.random.default_rng(SEED + 31)
        queries = np.concatenate([
            x[gen.choice(CLI_ROWS, 32, replace=False)]
            + 0.5 * gen.standard_normal((32, DIM), dtype=np.float32),
            gen.standard_normal((32, DIM), dtype=np.float32)])
        (o_vals, o_ids), (f_vals, f_ids) = oracle([(0, x)], queries, lambda r: r % 10)
        res, secs, _ = on_threads(
            lambda j: client.search(queries[j].astype(float).tolist(), limit=10,
                                    with_payload=False), range(64), threads=8)
        check_hits("serve subprocess k=10", [r.results for r in res], o_vals, o_ids, 10)
        res = [client.search(queries[j].astype(float).tolist(), limit=10, filter_sql="g = 3")
               for j in range(8)]
        check_hits("serve subprocess filtered", [r.results for r in res], f_vals[:8], f_ids[:8],
                   10)
        st = client.call("GetStats", pb.GetStatsRequest())
        code, text = rest_call(base, "GET", "/metrics")
        hbm = metric_value(text, "hbm_bytes_in_use")
        client.close()
        require(st.document_count == CLI_ROWS and code == 200 and hbm > 0,
                f"serve subprocess: {st.document_count} documents, /metrics {code}, "
                f"hbm_bytes_in_use {hbm}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
        require(rc == 0, f"serve exited with {rc} after an interrupt: {''.join(seen)[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    log(f"[times] cli serve subprocess on the default device: banner after {boot_s:.1f} s; "
        f"{CLI_ROWS} x {DIM} rows over gRPC in {CLI_ROWS // 1024} RPCs of 1,024 from 4 threads: "
        f"{ingest_s:.2f} s "
        f"({CLI_ROWS / ingest_s:.0f} rows/s, into the file store); 64 searches from 8 threads "
        f"({pct_ms(secs)}) and 8 filtered agree with the numpy oracle; /metrics "
        f"hbm_bytes_in_use {hbm:.0f}; exit code {rc} after SIGINT")

    def run(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        return ([json.loads(line) for line in buf.getvalue().splitlines() if line.strip()],
                time.perf_counter() - t0)

    for name, keys in CLI_KEYS.items():
        rows, sec = run([name])
        require(rows and all(set(r) == keys for r in rows),
                f"cli {name} printed {rows}, wanted the keys {sorted(keys)}")
        log(f"[cli] {name} ({sec:.1f} s): " + " ".join(json.dumps(r) for r in rows))
    rows, sec = run(["tune", "--data-dir", data])
    require(rows == [{"kind": "flat", "documents": CLI_ROWS}], f"cli tune printed {rows}")
    log(f"[cli] tune on the served data directory ({sec:.1f} s, reopen included): {rows[0]}")
    tmp.cleanup()
    phase_s = time.perf_counter() - t_phase
    log(f"[time] cli phase {phase_s:.1f} s")
    return phase_s


# -- the distributed tier ---------------------------------------------------------------

CLUSTER_BUDGET_S = 240.0  # cluster_path's two parts together
# documents of the in-process cluster: a cut of scale from 1,048,576 (the
# in-process part took 129.5 s on an H100) to make room in the limit for the sharded
# phase; each node still holds ~300k rows at capacity 524,288, so every leg
# runs B1 / B2
CLUSTER_DOCS = 7 << 16
CLUSTER_NODES = ("node-1", "node-2", "node-3")
CLUSTER_QUERIES = 256     # half near stored documents (of the first batch), half anywhere
CLUSTER_SEARCHES = 768    # session searches from 32 threads, at each k
CLUSTER_BATCH = 64        # search_batch's B
CLUSTER_DELETES = 1024
# rows the three serve processes take over gRPC: cut from 65,536 for the
# phase's budget (the uncut part took 103.6 s, 62.9 s of it the ingest),
# then from 16,384 to make room in the limit for the sharded phase
GRPC_ROWS = 1 << 13


class Pair:
    """A cluster hit ``(id, score)`` as check_hits reads one."""

    def __init__(self, hit):
        self.id, self.score = hit


def check_pairs(name, rows, o_vals, o_ids, k, exclude=frozenset()):
    check_hits(name, [[Pair(h) for h in row] for row in rows], o_vals, o_ids, k, exclude)


def wait_for(cond, timeout_s: float, what: str) -> float:
    """Seconds until cond() holds, polled every 20 ms; fails after timeout_s."""
    t0 = time.perf_counter()
    while not cond():
        require(time.perf_counter() - t0 < timeout_s, f"{what}: not within {timeout_s} s")
        time.sleep(0.02)
    return time.perf_counter() - t0


def cluster_path():
    """The distributed tier on the card, in two parts. In process: a
    ``ClusterService`` of 3 nodes, 16 shards, RF = 2 (the reference CLI's
    ``serve`` defaults on the 3-node minimum its README names) over the
    default flat, cosine, bf16 index at D = 768, every node's index on the
    card; 458,752 documents upserted with a session token (each node holds
    ~2/3 of them, so every shard-local leg runs B1 or B2), session searches
    from 32 threads through all three coordinators at k = 10 and 3,
    ``search_batch``, a delete, node-3 failed and recovered, each answer
    against the numpy oracle over the live documents; then B1 and B2 against
    their plain versions on node-1's plane. Over gRPC: three ``cli serve
    --node-id --peers`` processes on the card (default shard and replica
    counts), rows upserted at n1 and searched at n3, n2 killed, searches at
    n1. Returns ({B1/B2 name: its entry for this path}, phase seconds)."""
    from grape_vector_db_tpu_torch import Document, VectorDbConfig
    from grape_vector_db_tpu_torch.distributed.cluster_service import ClusterService
    from grape_vector_db_tpu_torch.distributed.types import ClusterConfig, SessionToken
    from grape_vector_db_tpu_torch.ops import distance
    from grape_vector_db_tpu_torch.ops.distance import scored_topk

    t_phase = time.perf_counter()
    seg_min = distance.SEGMAX_MIN_ROWS
    svc = ClusterService(list(CLUSTER_NODES), ClusterConfig(shard_count=16, replica_count=2),
                         VectorDbConfig(), device=DEV)
    svc.start()
    nodes = [svc.nodes[n] for n in CLUSTER_NODES]
    idx = nodes[0].db.index
    log(f"[cluster] ClusterService {list(CLUSTER_NODES)} on {DEV} ({CARD}): "
        f"{svc.config.shard_count} shards, RF {svc.config.replica_count}, consistency "
        f"{svc.config.consistency.value}; index {idx.kind}, {idx.metric}, {idx.storage_dtype}, "
        f"D={nodes[0].db.config.vector_dimension}; leader {nodes[0].raft.leader_id}")

    # host time of every shard-local leg batch (each node's micro-batcher calls)
    legs = []
    for n in nodes:
        inner = n._search_batcher._fn

        def timed_leg(q, k, inner=inner):
            t0 = time.perf_counter()
            try:
                return inner(q, k)
            finally:
                legs.append(time.perf_counter() - t0)

        n._search_batcher._fn = timed_leg

    rng = np.random.default_rng(SEED + 40)
    near = rng.choice(INGEST_BATCH, CLUSTER_QUERIES // 2, replace=False)
    _, first = next(corpus_batches())
    queries = np.concatenate([
        first[near] + 0.5 * rng.standard_normal((len(near), DIM), dtype=np.float32),
        rng.standard_normal((CLUSTER_QUERIES - len(near), DIM), dtype=np.float32)])
    del first
    tok = SessionToken()
    n_batches = CLUSTER_DOCS // INGEST_BATCH
    acked = []

    def ingest():
        """Upserts each batch, then hands it to the oracle."""
        for start, x in itertools.islice(corpus_batches(), n_batches):
            docs = [Document(id=f"doc{start + i}", content="", vector=x[i])
                    for i in range(len(x))]
            t0 = time.perf_counter()
            require(svc.upsert(docs, session=tok) == len(docs), "upsert wrote fewer")
            acked.append(time.perf_counter() - t0)
            yield start, x

    reset_counts()
    t0 = time.perf_counter()
    (o_vals, o_ids), _ = oracle(ingest(), queries, lambda rows: rows % 10)
    ingest_wall = time.perf_counter() - t0
    def stored():
        return [n.db.store.count() for n in nodes]

    settle_s = wait_for(lambda: sum(stored()) == 2 * CLUSTER_DOCS, 120.0,
                        "the asynchronous replica writes")
    per_node = stored()
    log(f"[times] cluster ingest {CLUSTER_DOCS} documents in batches of {INGEST_BATCH} "
        f"through ClusterService.upsert with a session: {sum(acked):.2f} s inside upsert "
        f"({CLUSTER_DOCS / sum(acked):.0f} docs/s acknowledged); every replica written "
        f"{settle_s:.2f} s after the oracle's pass ({ingest_wall:.2f} s with it); rows per "
        f"node {dict(zip(CLUSTER_NODES, per_node))}; capacity "
        f"{[n.db.index.capacity for n in nodes]}")
    # above this many rows every leg runs B1 (k >= 4) or B2 (k <= 3)
    require(all(r >= seg_min for r in per_node), f"a node holds under {seg_min} rows: "
            f"{per_node}")

    qlists = queries.astype(float).tolist()
    b0 = [(n._search_batcher.batches_run, n._search_batcher.queries_run) for n in nodes]
    hits10 = []
    for k in (10, 3):
        jobs = [(j % CLUSTER_QUERIES, k) for j in range(CLUSTER_SEARCHES)]
        leg0 = len(legs)
        res, secs, wall = on_threads(
            lambda a: nodes[a[0] % 3].search(qlists[a[0]], a[1], session=tok), jobs)
        for (j, _), row in zip(jobs, res):
            check_pairs(f"cluster search k={k} q{j}", [row], o_vals[j:j + 1], o_ids[j:j + 1], k)
        hits10 += [i for row in res for i, _ in row] if k == 10 else []
        log(f"[times] cluster search k={k} with the session, {SERVER_THREADS} threads over "
            f"the 3 coordinators, {len(jobs)} searches: {pct_ms(secs)}, "
            f"{len(jobs) / wall:.0f} QPS; the legs' vector_search_batch calls "
            f"{pct_ms(legs[leg0:])}; all exact")
    avg = {n.node_id: round((n._search_batcher.queries_run - q) / max(
        n._search_batcher.batches_run - b, 1), 2) for n, (b, q) in zip(nodes, b0)}
    log(f"[cluster] the nodes' micro-batchers: avg_batch {avg}")

    t0 = time.perf_counter()
    batch = nodes[0].search_batch(qlists[:CLUSTER_BATCH], k=10, session=tok)
    batch_s = time.perf_counter() - t0
    check_pairs(f"cluster search_batch B={CLUSTER_BATCH}", batch, o_vals, o_ids, 10)
    batch_med = timed(lambda: nodes[1].search_batch(qlists[:CLUSTER_BATCH], k=10), reps=5)
    log(f"[times] cluster search_batch B={CLUSTER_BATCH} k=10: {batch_s * 1e3:.3f} ms with "
        f"the session, median {batch_med * 1e3:.3f} ms of 5 without; exact")

    doomed = list(dict.fromkeys(int(i[3:]) for i in hits10))[:CLUSTER_DELETES]
    taken = set(doomed)
    doomed += [i for i in range(CLUSTER_DOCS) if i not in taken][:CLUSTER_DELETES - len(doomed)]
    n_del = svc.delete([f"doc{i}" for i in doomed], session=tok)
    require(n_del == CLUSTER_DELETES, f"deleted {n_del}, wanted {CLUSTER_DELETES}")
    gone = frozenset(doomed)
    res, secs, _ = on_threads(lambda j: nodes[j % 3].search(qlists[j], 10, session=tok),
                              range(CLUSTER_QUERIES))
    check_pairs("cluster search after delete", res, o_vals, o_ids, 10, exclude=gone)
    after = nodes[2].search_batch(qlists[:CLUSTER_BATCH], k=10, session=tok)
    check_pairs("cluster search_batch after delete", after, o_vals, o_ids, 10, exclude=gone)
    log(f"[cluster] deleted {n_del} ids (the top hits first): {CLUSTER_QUERIES} searches "
        f"({pct_ms(secs)}) and a batch again, exact, none of them back")
    launches = read_counts()

    # a leg batch's device span on node-1's index; then B1 and B2 on its plane
    qt = torch.from_numpy(queries[:CLUSTER_BATCH]).to(DEV)
    span = cuda_ms(lambda: scored_topk(qt, idx.vectors, idx.norms, idx.valid, 10,
                                       metric=idx.metric, chunk=min(65536, idx.capacity),
                                       mode=idx.search_mode), 20)
    log(f"[times] cluster device span of one leg batch B={CLUSTER_BATCH} k=10 on node-1 "
        f"({len(idx)} rows; scored_topk: B1 and phase 2; CUDA events, mean of 20): "
        f"{span:.3f} ms against the legs' host p50 "
        f"{np.percentile(np.array(legs) * 1e3, 50):.3f} ms")
    out = {name: index_plane_check("cluster node-1", name, idx, queries[:CLUSTER_BATCH])
           for name in ("segmax4", "segmax2")}

    # node-3 fails: every shard keeps one live owner at RF = 2
    reset_counts()
    n1 = nodes[0]
    t0 = time.perf_counter()
    svc.sim.fail_node("node-3")
    first_exact = None
    while first_exact is None:
        row = n1.search(qlists[0], 10)
        try:
            check_pairs("cluster search during failover", [row], o_vals, o_ids, 10, exclude=gone)
            first_exact = time.perf_counter() - t0
        except AssertionError:
            require(time.perf_counter() - t0 < 60.0, "no exact answer within 60 s of the failure")
    wait_for(lambda: n1.cluster_health().status != "healthy", 60.0,
             "node-1 detecting node-3's failure")
    detect_s = time.perf_counter() - t0
    res, secs, _ = on_threads(lambda j: n1.search(qlists[j], 10), range(CLUSTER_QUERIES))
    check_pairs("cluster search through node-1 after the failure", res, o_vals, o_ids, 10,
                exclude=gone)
    health = n1.cluster_health()
    log(f"[times] cluster failover: fail_node('node-3'); the first exact answer through "
        f"node-1 {first_exact:.3f} s after it, detection after {detect_s:.2f} s; "
        f"{CLUSTER_QUERIES} searches through node-1 then ({pct_ms(secs)}), exact; "
        f"cluster_health() {health.__dict__}")
    svc.sim.recover_node("node-3")
    t0 = time.perf_counter()
    back_s = wait_for(lambda: all(n.cluster_health().status == "healthy" for n in nodes),
                      60.0, "health back to healthy")
    log(f"[cluster] recover_node('node-3'): every node healthy after {back_s:.2f} s; "
        f"cluster_health() {n1.cluster_health().__dict__}")
    for name, n in read_counts().items():
        launches[name] += n
    for name in ("segmax4", "segmax2"):
        require(launches[name] > 0, f"the cluster path never launched {name}")
        out[name]["launches"] = launches[name]
    log(f"[cluster] kernel launches on the path {launches}")
    svc.stop()
    del svc, nodes, idx, n1, qt
    torch.cuda.empty_cache()
    inproc_s = time.perf_counter() - t_phase
    log(f"[time] cluster in-process part {inproc_s:.1f} s")
    grpc_s = cluster_grpc_part()
    phase_s = time.perf_counter() - t_phase
    log(f"[time] cluster phase {phase_s:.1f} s (in process {inproc_s:.1f} s, gRPC "
        f"{grpc_s:.1f} s; budget {CLUSTER_BUDGET_S:.0f} s"
        f"{', over it' if phase_s > CLUSTER_BUDGET_S else ''})")
    return out, phase_s


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cluster_grpc_part() -> float:
    """Three ``python3 -m grape_vector_db_tpu_torch.cli serve --node-id n<i>
    --peers ...`` processes on the card, the default shard and replica
    counts: GRPC_ROWS rows upserted at n1 from 4 client threads, searches at
    n3 with the upserts' session versions, each process's device memory from
    /metrics, n2 killed, searches at n1; every answer against the numpy
    oracle. Also the codec's share of the ingest: the Internal RPCs' msgpack
    work for the run's document hops at the per-document cost measured here.
    Returns the part's seconds."""
    import queue
    import signal
    import tempfile
    import threading

    from grape_vector_db_tpu_torch import Document
    from grape_vector_db_tpu_torch.distributed.shard import ShardMap
    from grape_vector_db_tpu_torch.server import grpc_server as gsrv
    from grape_vector_db_tpu_torch.server.proto import vector_db_pb2 as pb
    from grape_vector_db_tpu_torch.storage import msgpack_codec

    t_part = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory(prefix="gvdb_cluster_")
    ports = {f"n{i}": free_port() for i in (1, 2, 3)}
    peers = ",".join(f"{n}=127.0.0.1:{p}" for n, p in ports.items())
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, lines, seen, rest = {}, {}, {n: [] for n in ports}, {}
    for n in ports:
        procs[n] = subprocess.Popen(
            [sys.executable, "-m", "grape_vector_db_tpu_torch.cli", "serve", "--host",
             "127.0.0.1", "--rest-port", "0", "--node-id", n, "--peers", peers,
             "--data-dir", os.path.join(tmp.name, n)],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lines[n] = queue.Queue()
        threading.Thread(target=lambda p=procs[n], q=lines[n]: [q.put(x) for x in p.stdout],
                         daemon=True).start()
    clients = {}
    try:
        for n in ports:
            m = None
            deadline = time.monotonic() + 180
            while m is None and time.monotonic() < deadline and procs[n].poll() is None:
                try:
                    seen[n].append(lines[n].get(timeout=1.0))
                except queue.Empty:
                    continue
                m = re.search(r"serving: grpc=:(\d+) rest=([\d.]+):(\d+)", seen[n][-1])
            require(m is not None, f"{n} printed no banner: {''.join(seen[n])[-3000:]}")
            rest[n] = f"http://{m[2]}:{m[3]}"
            clients[n] = gsrv.VectorDbClient(f"127.0.0.1:{ports[n]}", timeout_s=120.0)
        boot_s = time.perf_counter() - t_part

        def converged():
            infos = [c.call("GetClusterInfo", pb.GetClusterInfoRequest(), timeout_s=5)
                     for c in clients.values()]
            return all(len(i.members) == 3 for i in infos) and any(i.leader_id for i in infos)

        join_s = wait_for(converged, 60.0, "the three processes' membership")
        x = np.random.default_rng(SEED + 41).standard_normal((GRPC_ROWS, DIM), dtype=np.float32)
        versions, vlock = {}, threading.Lock()

        def upsert(lo):
            r = clients["n1"].upsert_points([pb.Point(id=f"doc{i}", vector=pb.Vector(values=x[i]))
                                             for i in range(lo, lo + 1024)])
            require(r.upserted == 1024 and not r.error, f"UpsertVector at n1: {r.error}")
            with vlock:
                for sid, v in r.session_versions.items():
                    versions[sid] = max(v, versions.get(sid, 0))

        _, _, ingest_s = on_threads(upsert, range(0, GRPC_ROWS, 1024), threads=4)
        gen = np.random.default_rng(SEED + 42)
        queries = np.concatenate([
            x[gen.choice(GRPC_ROWS, 32, replace=False)]
            + 0.5 * gen.standard_normal((32, DIM), dtype=np.float32),
            gen.standard_normal((32, DIM), dtype=np.float32)])
        (o_vals, o_ids), _ = oracle([(0, x)], queries, lambda r: r % 10)
        qlists = queries.astype(float).tolist()

        def search_at(n):
            def one(j):
                r = clients[n].search(qlists[j], limit=10, with_payload=False,
                                      min_versions=versions)
                require(not r.error, f"SearchVectors at {n}: {r.error}")
                return r.results
            res, secs, _ = on_threads(one, range(len(qlists)), threads=8)
            check_hits(f"gRPC cluster search at {n}", res, o_vals, o_ids, 10)
            return secs

        secs3 = search_at("n3")
        hbm = {}
        for n in ports:
            code, text = rest_call(rest[n], "GET", "/metrics")
            hbm[n] = metric_value(text, "hbm_bytes_in_use")
        require(all(v > 0 for v in hbm.values()), f"hbm_bytes_in_use {hbm}")
        stats = {n: c.call("GetStats", pb.GetStatsRequest()).document_count
                 for n, c in clients.items()}
        procs["n2"].kill()
        procs["n2"].wait(timeout=30)
        clients.pop("n2").close()
        secs1 = search_at("n1")

        # the codec's work for the ingest's document hops: each row goes from n1
        # to each owner of its shard but n1, packed there and unpacked at the owner
        smap = ShardMap(shard_count=16, replica_count=2)
        smap.assign_all(sorted(ports))
        hops = sum(o != "n1" for i in range(GRPC_ROWS)
                   for o in smap.nodes_for_key(f"doc{i}").all_nodes())
        payload = {"docs": [Document(id=f"doc{i}", content="",
                                     vector=x[i].astype(float).tolist()).to_dict()
                            for i in range(64)]}
        pack_s = timed(lambda: msgpack_codec.packb(payload, use_bin_type=True), reps=5) / 64
        raw = msgpack_codec.packb(payload)
        unpack_s = timed(lambda: msgpack_codec.unpackb(raw, raw=False), reps=5) / 64
        log(f"[times] cluster gRPC: 3 serve processes on the card, banners after "
            f"{boot_s:.1f} s, membership after {join_s:.2f} s more; {GRPC_ROWS} x {DIM} rows by "
            f"UpsertVector at n1 ({GRPC_ROWS // 1024} RPCs of 1,024 from 4 threads): "
            f"{ingest_s:.2f} s "
            f"({GRPC_ROWS / ingest_s:.0f} rows/s); documents per process {stats}; 64 searches "
            f"at n3 ({pct_ms(secs3)}) with the session versions, exact; hbm_bytes_in_use "
            f"{hbm}; n2 killed: 64 searches at n1 ({pct_ms(secs1)}), exact")
        log(f"[times] cluster gRPC codec: {hops} document hops (n1 to another owner) x "
            f"({pack_s * 1e3:.4f} ms pack + {unpack_s * 1e3:.4f} ms unpack a 768-float document, "
            f"measured here) = {hops * (pack_s + unpack_s):.2f} s of codec work against the "
            f"ingest's {ingest_s:.2f} s wall ({hops * (pack_s + unpack_s) / ingest_s:.2f} of it, "
            f"spread over the processes' threads)")
        for n in ("n1", "n3"):
            procs[n].send_signal(signal.SIGINT)
        for n in ("n1", "n3"):
            rc = procs[n].wait(timeout=60)
            require(rc == 0, f"{n} exited with {rc} after SIGINT: {''.join(seen[n])[-3000:]}")
    finally:
        for c in clients.values():
            c.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        tmp.cleanup()
    return time.perf_counter() - t_part


# -- the examples: examples_torch/ on the card ----------------------------------

EXAMPLES_BUDGET_S = 90.0
# the examples whose run must launch these kernels (B4 / B5 and their grouping pass)
EXAMPLES_KERNELS = {"int8_ivf_demo": "ivf_probe_int8", "capacity_tier_demo": "ivf_probe_int4",
                    "sharded_mesh_demo": "ivf_probe_int8"}


def load_path(name: str, path: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(parity, mod, device: str):
    """(stdout, result) of the example's ``main`` on ``device``, run in a
    temporary directory (with its ``data_dir`` there where it takes one)."""
    import contextlib
    import io
    import tempfile

    buf, cwd = io.StringIO(), os.getcwd()
    with tempfile.TemporaryDirectory(prefix="gvdb_example_") as tmp:
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(buf):
                result = mod.main(**parity.main_kwargs(mod.main, tmp, device))
        finally:
            os.chdir(cwd)
    return buf.getvalue(), result


def examples_path():
    """Every example of examples_torch/ in process, in the order of
    tests/examples_parity.py's EXAMPLES, with ``main(device="cuda")``; each
    one's stdout held against its run on the CPU (the same process) under
    the parity rules; B4 launched by int8_ivf_demo and sharded_mesh_demo, B5
    by capacity_tier_demo; B4 and B5 held against their plain versions at
    D = 128 on the int8 bandwidth index's and the ivf_int4 index's own
    planes. Returns (each example's kernel launches, B4's and B5's D = 128
    stats)."""
    from grape_vector_db_tpu_torch.ops import ivf as tivf

    root = os.path.dirname(os.path.abspath(__file__))
    parity = load_path("examples_parity", os.path.join(root, "tests", "examples_parity.py"))
    t_phase = time.perf_counter()
    counts, stats = {}, {}
    for name in parity.EXAMPLES:
        mod = load_path(f"example_{name}", os.path.join(root, "examples_torch", f"{name}.py"))
        reset_counts()
        t0 = time.perf_counter()
        out, result = run_example(parity, mod, DEV)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts[name] = {k: v for k, v in read_counts().items() if v}
        for line in out.splitlines():
            log(f"[examples] {name}: {line}")
        t0 = time.perf_counter()
        ref, _ = run_example(parity, mod, "cpu")
        cpu_s = time.perf_counter() - t0
        parity.compare(name, ref, out, ref_is_jax=False)
        kname = EXAMPLES_KERNELS.get(name)
        if kname:
            require(counts[name].get(kname, 0) > 0, f"{name}: the run never launched {kname}")
            require(counts[name].get("ivf_group", 0) == counts[name][kname],
                    f"{name}: its probes and grouping passes differ in number")
        log(f"[examples] {name}: {card_s:.2f} s on the card ({cpu_s:.2f} s on the CPU); its "
            f"output matches the CPU run's; kernel launches {counts[name]}")
        if name in ("int8_ivf_demo", "capacity_tier_demo"):
            # the index the run built, at the queries its search gives the probe:
            # the bandwidth index's 64 queries, and the ivf_int4 db's
            # single-query search padded to the batch of 8
            idx = result["bandwidth"] if name == "int8_ivf_demo" else result["index"]
            queries = result["queries"][:64 if name == "int8_ivf_demo" else 8]
            qp, probe = tivf._probe_lists(torch.from_numpy(queries).to(DEV), idx.centroids,
                                          idx.nprobe, idx.metric)
            stats[kname] = {"path": name, "launches": counts[name][kname],
                            **codes_probe_check(kname, idx, qp, probe, f"D={qp.shape[1]}")}
        del result
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"[time] examples phase {phase_s:.1f} s (budget {EXAMPLES_BUDGET_S:.0f} s"
        f"{', over it' if phase_s > EXAMPLES_BUDGET_S else ''})")
    return counts, stats


def main():
    global PARENT
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="the parent commit's tree: time its B5 and B6 "
                        "kernels in turns with this tree's")
    PARENT = parser.parse_args().parent
    t_start = time.perf_counter()
    setup()
    kernel_stats = segmax_phase()
    variant_stats, variant_launches = segmax_variants_phase()
    kernel_stats.update(variant_stats)
    torch.cuda.empty_cache()
    probe_adversarial()
    kernel_stats["hamming"] = hamming_phase()
    torch.cuda.empty_cache()
    kernel_stats["asym"] = asym_phase()
    torch.cuda.empty_cache()
    launches, flat_db = flat_path()
    launches.update(variant_launches)
    server_stats, server_s = server_path(flat_db)
    del flat_db
    torch.cuda.empty_cache()
    cli_s = cli_path()
    log(f"[time] server and cli phases {server_s + cli_s:.1f} s (budget {SERVER_BUDGET_S:.0f} s"
        f"{', over it' if server_s + cli_s > SERVER_BUDGET_S else ''})")
    log(f"[time] {time.perf_counter() - t_start:.1f} s so far")
    corpus = Clustered(IVF_ROWS)
    # each IVF kind on one card, then its sharded twin on the same corpus,
    # held to the single card's answers with its centroids
    probe_paths, group_launches = {}, {}
    for kind, nlist in (("ivf", IVF_NLIST), ("ivf_int8", QUANT_NLIST), ("ivf_int4", QUANT_NLIST)):
        if kind != "ivf" and QUANT_ROWS != corpus.rows:
            corpus = Clustered(QUANT_ROWS)
        if kind == "ivf_int8":
            log(f"[ivf] the quantized kinds run at {QUANT_ROWS} rows, nlist {QUANT_NLIST}")
        name = IVF_KERNEL[kind]
        counts, kernel_stats[name], single = ivf_path(kind, corpus, nlist)
        torch.cuda.empty_cache()
        s_counts, s_stats = sharded_ivf_part(kind, corpus, nlist, single,
                                             min(SHARDED_IVF_ROWS, corpus.rows))
        del single
        probe_paths[name] = {"ivf": counts[name], "sharded": s_counts[name]}
        if kind != "ivf":   # B4/B5's grouping pass: one a probe
            group_launches[kind] = counts["ivf_group"]
            group_launches[f"sharded_{kind}"] = s_counts["ivf_group"]
            group = kernel_stats[name].pop("group")
            s_group = s_stats.pop("group")
            if kind == "ivf_int4":
                kernel_stats["ivf_group"] = {**group, "sharded": {"path": "sharded_ivf_int4",
                                                                  **s_group}}
        kernel_stats[name]["sharded"] = {"path": f"sharded_{kind}", "plane": "shard 0",
                                         "launches": s_counts[name], **s_stats}
        torch.cuda.empty_cache()
        log(f"[time] {time.perf_counter() - t_start:.1f} s so far")
    del corpus
    flat_counts, flat_planes = sharded_flat_part()
    torch.cuda.empty_cache()
    log(f"[time] {time.perf_counter() - t_start:.1f} s so far")
    launches["hamming"], asym_binary = binary_path()
    torch.cuda.empty_cache()
    log(f"[time] {time.perf_counter() - t_start:.1f} s so far")
    corpora = {c.name: c for c in small_corpora()}
    for label, kind, cname, updates, kname in SMALL_KINDS:
        counts, stats = small_kind_path(label, kind, corpora[cname], updates, kname)
        if kname is not None:   # the projected path's own run of B4/B5, at D = R
            group = stats.pop("group")
            kernel_stats[kname][f"d{PROJ_DIM}"] = {"path": kind, "launches": counts[kname],
                                                   **stats}
            d_group = kernel_stats["ivf_group"].setdefault(f"d{PROJ_DIM}", {
                "launches": 0, "launches_by_path": {}})
            d_group["launches"] += counts["ivf_group"]
            d_group["launches_by_path"][kind] = counts["ivf_group"]
            if kname == "ivf_probe_int4":
                d_group.update({"path": kind, **group})
        torch.cuda.empty_cache()
        log(f"[time] {time.perf_counter() - t_start:.1f} s so far")
    # the projected kind sharded: B4 at D = R on each of the mesh's shards
    t_part = time.perf_counter()
    counts, _ = small_kind_path("sharded_ivf_int8_proj", "sharded_ivf_int8_proj",
                                corpora["low-rank"], {}, "ivf_probe_int8",
                                n_shards=SHARDED_SHARDS)
    probe_paths["ivf_probe_int8"]["sharded_proj"] = counts["ivf_probe_int8"]
    group_launches["sharded_ivf_int8_proj"] = counts["ivf_group"]
    SHARDED_SECONDS["sharded_ivf_int8_proj"] = time.perf_counter() - t_part
    sharded_report()
    torch.cuda.empty_cache()
    clustered = corpora["clustered"]
    del corpora
    (launches["gather_dots"], launches["gather_dots@build"], launches["gather_group"],
     graph_stats) = graph_path(
        SmallCorpus("clustered", clustered.x[:GRAPH_ROWS], clustered.queries))
    kernel_stats.update(graph_stats)
    log(f"[time] {time.perf_counter() - t_start:.1f} s so far")
    del clustered
    torch.cuda.empty_cache()
    flat_b1, embedded_b1 = launches["segmax4"], embedded_path()
    torch.cuda.empty_cache()
    log(f"[time] {time.perf_counter() - t_start:.1f} s so far")
    cluster_stats, _ = cluster_path()
    torch.cuda.empty_cache()
    example_counts, example_stats = examples_path()
    ex_launches = {k: sum(c.get(k, 0) for c in example_counts.values()) for k in KERNELS}
    for name, d128 in example_stats.items():
        group = d128.pop("group")
        probe_paths[name]["examples"] = ex_launches[name]
        kernel_stats[name]["d128"] = d128
        if name == "ivf_probe_int4":
            kernel_stats["ivf_group"]["d128"] = {
                "path": d128["path"], "launches": d128["launches"], **group}
    group_launches["examples"] = ex_launches["ivf_group"]
    asym_paths = {"binary": asym_binary, "examples": ex_launches["asym"]}
    launches["asym"] = sum(asym_paths.values())
    kernel_stats["asym"]["launches_by_path"] = asym_paths
    log(f"[kernels] asym launches by path: {asym_paths}")
    log(f"[kernels] examples phase launches by example: {example_counts}")
    by_path = {"segmax4": {"flat": flat_b1, "server": server_stats["segmax4"]["launches"],
                           "embedded": embedded_b1["launches"],
                           "cluster": cluster_stats["segmax4"]["launches"],
                           "sharded": flat_counts["segmax4"],
                           "examples": ex_launches["segmax4"]},
               "segmax2": {"flat": launches["segmax2"],
                           "server": server_stats["segmax2"]["launches"],
                           "cluster": cluster_stats["segmax2"]["launches"],
                           "sharded": flat_counts["segmax2"],
                           "examples": ex_launches["segmax2"]}}
    for name, paths in by_path.items():
        launches[name] = sum(paths.values())
        kernel_stats[name]["launches_by_path"] = paths
        kernel_stats[name]["server"] = server_stats[name]
        kernel_stats[name]["cluster"] = cluster_stats[name]
        kernel_stats[name]["sharded"] = {"path": "sharded_flat", "plane": "shard 0",
                                         "launches": flat_counts[name], **flat_planes[name]}
        log(f"[kernels] {name} launches by path: {paths}")
    for name, paths in probe_paths.items():
        launches[name] = sum(paths.values())
        kernel_stats[name]["launches_by_path"] = paths
        log(f"[kernels] {name} launches by path: {paths}")
    launches["ivf_group"] = sum(group_launches.values())
    kernel_stats["ivf_group"]["launches_by_path"] = group_launches
    log(f"[kernels] ivf_group launches by path: {group_launches}")
    kernel_stats["segmax4"]["embedded"] = embedded_b1
    log(f"[time] {time.perf_counter() - t_start:.1f} s so far")
    # a phase's stats never overwrite the identifying keys
    entries = [{**kernel_stats[name], "name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": launches[name]}
               for name, (src, tpu) in KERNELS.items()]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    require(all(k in e for e in entries for k in keys), "a kernel entry lacks a key")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

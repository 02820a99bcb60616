"""What may differ between two runs of an example, and how to compare them.

``compare(name, ref_out, port_out)`` holds the stdout of one of the port's
examples (examples_torch/) line by line against a reference run of the same
example: its JAX twin's (examples/) in tests/test_torch_examples.py on the
CPU, or the port's own run on the CPU in chip_smoke.py's examples phase on
the card. What may differ is masked or compared within a tolerance, each
rule below with its reason; every other line must be equal. It imports
nothing of either package.
"""

import inspect
import os
import re

EXAMPLES = [
    "embedded_mode_simple",
    "embedded_mode_complete",
    "single_node_simple",
    "single_node_server",
    "advanced_filtering_demo",
    "advanced_storage_demo",
    "openai_compatible",
    "binary_quantization_demo",
    "int8_ivf_demo",
    "capacity_tier_demo",
    "builtin_load_balancing_demo",
    "cluster_3node_simple",
    "cluster_3node_complete",
    "runtime_scaling_demo",
    "sharded_mesh_demo",
]

# The port names no TPU, so two documents of the examples' data are renamed
# in the counterparts. The JAX twin runs with the same rename (made here, on
# its source text), so that those lines still compare exactly.
JAX_RENAMES = {
    "embedded_mode_simple": [('id="tpu", title="TPU"', 'id="gpu", title="GPU"')],
    "openai_compatible": [('"TPUs multiply', '"GPUs multiply')],
}

# Masks applied to both sides' lines before they are compared.
MASKS = [
    # wall-clock times, rates and speed ratios: measurements of this run
    (re.compile(r"\d+ ms\b"), "<ms>"),
    (re.compile(r"[\d,]+ q/s"), "<q/s>"),
    (re.compile(r"\(\d+\.\dx\)"), "(<ratio>)"),
    (re.compile(r"\d+\.\dx vs exact"), "<ratio> vs exact"),
    # servers bind port 0: the kernel picks the port
    (re.compile(r":\d{2,5}\b"), ":<port>"),
]

# Per example, lines whose text differs between the two packages or from run
# to run: (pattern, rule). The pattern's groups are what the rule compares.
#   "any"     the groups may differ;
#   "within"  each group is a number, and the two agree within RECALL_TOL;
#   "port"    the port's groups must be the values given with the rule.
RECALL_TOL = 0.02
LINE_RULES = {
    # the backend: the JAX line names its backend and says where to run
    # for the real ratio; the port's names the torch device
    "binary_quantization_demo": [(re.compile(r"^corpus: 10000 x 512 \((.*)\)$"), "any")],
    # the store's size estimate varies from run to run in the JAX package itself
    "advanced_storage_demo": [(re.compile(r"^stats: docs=190 bytes~(\d+)$"), "any")],
    # weighted_round_robin draws from the unseeded random module
    # (distributed/load_balancer.py): only the three node names are kept
    "builtin_load_balancing_demo": [
        (re.compile(r"^  weighted_round_robin   -> \{'fast': '(\d+)%', 'medium': '(\d+)%', "
                    r"'slow': '(\d+)%'\}$"), "any")],
    # recall after k-means training, which differs between engines (ROADMAP
    # "Ties and trained state")
    "int8_ivf_demo": [(re.compile(r"^bandwidth config : recall@10 ([\d.]+)  "), "within"),
                      (re.compile(r"^capacity config  : recall@10 ([\d.]+)  "), "within")],
    "capacity_tier_demo": [
        (re.compile(r"^recall@10 codes-only device ranking : ([\d.]+)$"), "within")],
    # the JAX side runs on the suite's 8 virtual CPU devices, the port on its
    # one CPU device or on the card; auto_shard upgrades only on a host of
    # more than one device (ROADMAP C.1)
    "sharded_mesh_demo": [(re.compile(r"^devices: (\d+) x (\w+)$"), "any"),
                          (re.compile(r"^auto_shard upgraded 'flat' -> (\w+)$"),
                           ("port", ("flat",)))],
}

# The cluster demos' leader is whichever node wins the first election, and
# the failing node is the first one that is not the leader: only the set of
# names is kept, and the status lines' roles as a multiset. Their document
# counts are not compared: the status is read while the repair after the
# node failure may still be moving documents (seen from run to run of one
# package: a leader at 7 of 60 documents, or at 60).
NODES = {"alpha", "beta", "gamma"}
NODE_LINE = re.compile(r"^(leader|failing node): (\w+)$")
STATUS_LINE = re.compile(r"^  (\w+): role=(\w+) docs=\d+$")


def main_kwargs(main, where, device=None):
    """The keyword arguments an example's ``main`` is run with: its
    ``data_dir`` under ``where`` and ``device``, where it takes them."""
    params = inspect.signature(main).parameters
    kwargs = {}
    if "data_dir" in params:
        kwargs["data_dir"] = os.path.join(where, "data")
    if device is not None and "device" in params:
        kwargs["device"] = device
    return kwargs


def masked(line):
    for pat, rep in MASKS:
        line = pat.sub(rep, line)
    return line


def compare(name, ref_out, port_out):
    """Raise AssertionError, naming the two lines, where ``port_out`` differs
    from ``ref_out`` other than the rules allow."""
    j_lines, p_lines = ref_out.splitlines(), port_out.splitlines()
    assert len(j_lines) == len(p_lines), (j_lines, p_lines)
    j_status, p_status = [], []
    for j, p in zip(j_lines, p_lines):
        j, p = masked(j), masked(p)
        mj, mp = NODE_LINE.match(j), NODE_LINE.match(p)
        if mj and mp:
            assert mj[1] == mp[1] and mj[2] in NODES and mp[2] in NODES, (j, p)
            continue
        mj, mp = STATUS_LINE.match(j), STATUS_LINE.match(p)
        if mj and mp:
            j_status.append(mj.groups())
            p_status.append(mp.groups())
            continue
        for pat, rule in LINE_RULES.get(name, []):
            mj, mp = pat.match(j), pat.match(p)
            if not (mj and mp):
                continue
            assert pat.sub("", j) == pat.sub("", p), (j, p)
            if rule == "within":
                for a, b in zip(mj.groups(), mp.groups()):
                    assert abs(float(a) - float(b)) <= RECALL_TOL, (j, p)
            elif rule != "any":
                assert mp.groups() == rule[1], p
            break
        else:
            assert j == p, (j, p)
    assert sorted(n for n, _ in j_status) == sorted(n for n, _ in p_status)
    assert set(n for n, _ in p_status) <= NODES
    assert sorted(r for _, r in j_status) == sorted(r for _, r in p_status)

"""LLMapReduce over synthetic text shards, on the PyTorch port's task arrays: the canonical 3-array DAG.

    shards (map)  ->  counts (map)  ->  top (reduce)

`shards` generates deterministic zipf-ish word shards, `counts` computes
per-shard word histograms, `top` merges them and reports the top-k. The
SAME graph runs on all three repro_torch.exec backends (payloads carry both
fn and cmd); the port's copies of the exec and taskarray layers, no model:

    PYTHONPATH=src python examples/torch_mapreduce_wordstats.py --backend sim
    PYTHONPATH=src python examples/torch_mapreduce_wordstats.py --backend procpool
    PYTHONPATH=src python examples/torch_mapreduce_wordstats.py --backend inline

--inject fails one count task (retried with backoff) and straggles
another (re-dispatched once k x median elapses) — watch the summary lines.
The top-k must equal a plain count of the same shards.
"""
from __future__ import annotations

import argparse

from repro_torch.exec import get_backend
from repro_torch.taskarray import RetryPolicy, TaskGraph

VOCAB = ["the", "of", "launch", "node", "core", "octave", "matlab",
         "interactive", "scheduler", "cluster", "task", "array"]

# fn and cmd encode IDENTICAL logic: fn for sim/inline, cmd for the real
# worker pool (where payloads cross a process boundary as source text).
SHARD_CMD = ("[params['vocab'][int(random.Random(params['seed'] * 31 + j)"
             ".paretovariate(1.1)) % len(params['vocab'])]"
             " for j in range(params['n_words'])]")

COUNT_CMD = ("{w: inputs['shards'][params['i']].count(w)"
             " for w in set(inputs['shards'][params['i']])}")

TOP_CMD = ("sorted({w: sum(c.get(w, 0) for c in"
           " inputs['counts'][params['lo']:params['hi']]) for w in"
           " {k for c in inputs['counts'] for k in c}}.items(),"
           " key=lambda kv: -kv[1])[:params['k']]")


def shard_fn(params, inputs):
    import random
    vocab, n = params["vocab"], params["n_words"]
    return [vocab[int(random.Random(params["seed"] * 31 + j)
                      .paretovariate(1.1)) % len(vocab)]
            for j in range(n)]


def count_fn(params, inputs):
    shard = inputs["shards"][params["i"]]
    return {w: shard.count(w) for w in set(shard)}


def top_fn(params, inputs):
    merged = {}
    for c in inputs["counts"][params["lo"]:params["hi"]]:
        for w, n in c.items():
            merged[w] = merged.get(w, 0) + n
    return sorted(merged.items(), key=lambda kv: -kv[1])[:params["k"]]


def build_graph(n_shards: int = 16, n_words: int = 200, k: int = 5,
                inject: bool = False) -> TaskGraph:
    g = TaskGraph("wordstats")
    shards = g.map(shard_fn,
                   [{"seed": s, "n_words": n_words, "vocab": VOCAB}
                    for s in range(n_shards)],
                   cmd=SHARD_CMD, name="shards", work_seconds=0.4)
    counts = g.map(count_fn, [{"i": i} for i in range(n_shards)],
                   cmd=COUNT_CMD, name="counts", deps=[shards],
                   work_seconds=0.6)
    g.reduce(top_fn, counts, cmd=TOP_CMD, name="top", work_seconds=1.0)
    # reduce() slices cover everything; add k to the single reducer task
    g.arrays[-1].tasks[0].params["k"] = k
    if inject:
        counts.tasks[1].fail_attempts = 1      # fails once, retried
        counts.tasks[n_shards // 2].straggle_factor = 8.0   # slow node
    return g


def plain_counts(n_shards: int, n_words: int):
    """Every word's count, taken in one pass over the same shards."""
    counts = {}
    for s in range(n_shards):
        for w in shard_fn({"seed": s, "n_words": n_words, "vocab": VOCAB},
                          {}):
            counts[w] = counts.get(w, 0) + 1
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", "--runner", dest="backend",
                    choices=("sim", "procpool", "real", "inline"),
                    default="sim",
                    help="repro_torch.exec backend ('real' = procpool alias)")
    ap.add_argument("--shards", type=int, default=16)
    ap.add_argument("--words", type=int, default=200)
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--inject", action="store_true",
                    help="inject one task failure + one straggler")
    args = ap.parse_args(argv)

    g = build_graph(args.shards, args.words, args.top, inject=args.inject)
    policy = RetryPolicy(max_retries=2, backoff=0.1, straggler_k=3.0,
                         scan_period=0.1)
    kwargs = ({"n_launchers": 2, "workers_per_launcher": 4}
              if args.backend in ("procpool", "real") else {})
    with get_backend(args.backend, **kwargs) as backend:
        res = g.run(backend, policy)

    print(res.report())
    print(f"events: {res.events.counts()}")
    top = res["top"].values[0]
    print(f"top-{args.top} words over {args.shards} shards: "
          + ", ".join(f"{w}={n}" for w, n in top))
    if not res.all_ok:
        raise SystemExit("some tasks failed permanently")
    # words of equal count may come in either order: the counts must be
    # the plain count's k largest, each word's its plain count
    plain = plain_counts(args.shards, args.words)
    if ([n for _, n in top] != sorted(plain.values(), reverse=True)[:args.top]
            or any(plain[w] != n for w, n in top)):
        raise SystemExit(f"top-{args.top} {top} differs from a plain count "
                         f"{sorted(plain.items(), key=lambda kv: -kv[1])}")
    print("top-k equals a plain count")
    return res


if __name__ == "__main__":
    main()

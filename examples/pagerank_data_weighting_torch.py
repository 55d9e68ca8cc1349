"""PageRank as a data-curation stage, on the port.

    PYTHONPATH=src python examples/pagerank_data_weighting_torch.py \\
        --device cpu
    PYTHONPATH=src python examples/pagerank_data_weighting_torch.py \\
        --n-docs 1048576

The JAX package's examples/pagerank_data_weighting.py on `repro_torch`: a
synthetic document hyperlink graph is scored with SIMPLE-PAGERANK (on the
card unless `--device` names another device), the scores weight the
training-data sampler, and the realized document distribution is held to
PageRank importance. The sampler is host numpy, and a few thousand draws
cannot resolve a million frequencies: the correlation is read over the
`min(n_docs, 400)` highest-scored documents (every document at the
default size, as in the JAX example), and the steps double from 200
until those documents expect at least 16 draws each (the JAX example's
6,400 draws over 400 documents). Exits non-zero unless corr > 0.9.
"""
import argparse

import numpy as np

from repro_torch import prng
from repro_torch.core import normalized, simple_pagerank
from repro_torch.data import DataConfig, PageRankWeightedSampler
from repro_torch.graphs import doc_link_graph
from repro_torch.launch.stages import Stages, device_lines, device_or_exit

TOP_DOCS = 400           # the documents the correlation is read over
DRAWS_PER_DOC = 16       # their expected draws, at least
CORR_MIN = 0.9


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    for line in device_lines(device):
        print(line)
    stages = Stages(device)

    n_docs = args.n_docs
    with stages("graph"):
        g = doc_link_graph(n_docs, seed=0, device=device)
    with stages("simple_pagerank"):
        res = simple_pagerank(g, eps=0.15, walks_per_node=64,
                              key=prng.PRNGKey(0), device=device)
    scores = np.asarray(normalized(res.pi))
    top5 = np.argsort(-scores)[:5].tolist()
    print(f"scored {n_docs} docs; top-5: {top5}")

    cfg = DataConfig(vocab_size=1024, seq_len=64, global_batch=32)
    sampler = PageRankWeightedSampler(scores, cfg)
    batch = sampler.batch_at(0)
    doc_ids = batch["doc_ids"][:8].tolist()
    print(f"batch: tokens{batch['tokens'].shape} doc_ids sample {doc_ids}")

    k = min(n_docs, TOP_DOCS)
    top = np.sort(np.argsort(-scores)[:k])
    steps = 200
    while steps * cfg.global_batch * sampler.p[top].sum() \
            < DRAWS_PER_DOC * k:
        steps *= 2
    with stages("sampler"):
        freq = sampler.empirical_doc_freq(steps=steps)
    draws = int(round(freq[top].sum() * steps * cfg.global_batch))
    corr = float(np.corrcoef(freq[top], scores[top])[0, 1])
    top_score = set(np.argsort(-scores)[:20].tolist())
    top_freq = set(np.argsort(-freq)[:20].tolist())
    overlap = len(top_score & top_freq)
    print(f"empirical-vs-PageRank corr: {corr:.3f}  "
          f"top-20 overlap: {overlap}/20")
    print(f"sampler: {steps} steps x {cfg.global_batch} draws; the {k} "
          f"highest-scored docs received {draws} ({draws / k:.1f} each)")
    stages.print()
    out = dict(device=str(device), n_docs=n_docs, rounds=res.logical_rounds,
               scores=scores, top5=top5, doc_ids=doc_ids, steps=steps,
               top_docs=k, draws=draws, corr=corr, top20_overlap=overlap,
               **stages.report())
    if not corr > CORR_MIN:
        raise SystemExit(f"pagerank_data_weighting: check failed: corr "
                         f"{corr:.3f} <= {CORR_MIN}")
    return out


if __name__ == "__main__":
    main()

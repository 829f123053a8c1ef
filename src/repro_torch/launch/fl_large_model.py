"""FedS3A over a model-zoo transformer: the reduced qwen2-1.5b federated as
a final-token classifier through the paper's faulted round (semi-async
scheduling, pseudo-labels, group k-means aggregation, sparse-difference
communication with error feedback, crashes, lost uploads and a round
deadline), on the chunked parameter axis. Port of
``examples/fl_large_model.py``: the same flags, environment knobs and
printed lines.

``FedS3AConfig(model=<ModelConfig>, chunk_size=...)`` splits the flat
parameter vector into leaf-aligned chunks; the upload encode, the server
blend and the ring advance go one chunk at a time.

  PYTHONPATH=src python -m repro_torch.launch.fl_large_model
  PYTHONPATH=src python -m repro_torch.launch.fl_large_model --device cpu

``--device`` defaults to ``cuda`` (the card) and raises without one.
Environment knobs, as the reference example's: ``EXAMPLES_ROUNDS``
overrides the round count (6), ``EXAMPLES_LM_CLIENTS`` the fleet width
(8), ``EXAMPLES_LM_CHUNKS`` the target chunk count (6).
"""
from __future__ import annotations

import argparse
import os

from repro_torch.configs import get_config, load_all
from repro_torch.core import FedS3AConfig, FedS3ATrainer, TrafficModel
from repro_torch.data import make_lm_dataset
from repro_torch.launch.serve import _resolve_device


def main(argv=None):
    """Run the example; returns the trainer after its last round."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--rounds", type=int,
                    default=int(os.environ.get("EXAMPLES_ROUNDS", "6")))
    ap.add_argument("--clients", type=int,
                    default=int(os.environ.get("EXAMPLES_LM_CLIENTS", "8")))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = str(_resolve_device(args.device))

    load_all()
    cfg_model = get_config(args.arch).reduced()
    n = cfg_model.param_count()
    print(f"arch={args.arch} reduced: {cfg_model.num_layers}L "
          f"d={cfg_model.d_model} vocab={cfg_model.vocab_size} "
          f"-> {n:,} params, M={args.clients} clients")

    data = make_lm_dataset(args.clients, vocab_size=cfg_model.vocab_size,
                           seq_len=16, num_classes=8,
                           samples_per_client=48, seed=0)
    print(f"  server: {len(data['server']['x'])} labeled, "
          f"test: {len(data['test']['x'])}")

    chunk_size = -(-n // int(os.environ.get("EXAMPLES_LM_CHUNKS", "6")))
    cfg = FedS3AConfig(
        model=cfg_model, chunk_size=chunk_size,
        rounds=args.rounds, C=0.5, tau=2, batch_size=16, lr=5e-4,
        error_feedback=True,
        traffic=TrafficModel(crash_rate=0.05, upload_loss=0.05),
        round_deadline=2000.0, quorum_floor=1,
        seed=0, device=device,
    )
    trainer = FedS3ATrainer(data, cfg)
    lay = trainer.layout
    print(f"\nlayout: {lay.num_chunks} chunks "
          f"(max {lay.max_chunk:,}, min {min(lay.sizes):,}) over "
          f"n={lay.n:,}; engine={trainer.engine}")
    dense = 4 * trainer.store.ring.shape[1] * \
        max(int(cfg.C * args.clients), 1)
    print(f"peak device delta bytes: "
          f"{trainer.peak_delta_device_bytes():,} "
          f"(dense K*N would be {dense:,})")

    for _ in range(cfg.rounds):
        log = trainer.run_round()
        m = trainer.evaluate()
        flags = "degraded " if log.degraded else ""
        print(f"  round {log.round:2d}  quorum={log.quorum}/{log.target_k}"
              f"  crashes={log.crashes}  lost={len(log.lost)}  {flags}"
              f"acc={m['accuracy']:.4f}")
    final = trainer.evaluate()
    wb = trainer.comm.wire_breakdown()
    print(f"\nfinal: acc={final['accuracy']:.4f}  ACO={trainer.comm.aco:.3f}")
    print(f"wire layout: {wb['layout']}")
    return trainer


if __name__ == "__main__":
    main()

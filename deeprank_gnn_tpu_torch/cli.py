"""Command-line interface of the port (the JAX package's ``cli.py``):

    python -m deeprank_gnn_tpu_torch graphgen  --pdb ... --ref ... --pssm ... --out g.hdf5
    python -m deeprank_gnn_tpu_torch train     --database g.hdf5 --target fnat ...
    python -m deeprank_gnn_tpu_torch test      --database g.hdf5 --checkpoint m.pth.tar
    python -m deeprank_gnn_tpu_torch add-target  g.hdf5 name targets.lst
    python -m deeprank_gnn_tpu_torch hdf5-to-csv train_data.hdf5

with the JAX package's flags, defaults and printed lines, and two more:
``--device`` (``cuda``, the default, or ``cpu``) on ``graphgen``, ``train``
and ``test`` (where the featurizer's geometry or the model runs), and
``train``'s ``--dense-fast`` (the JAX package's ``DRGNN_DENSE_FAST``).
"""

from __future__ import annotations

import argparse


def _model_cls(name: str):
    from deeprank_gnn_tpu_torch.models import MODELS

    if name not in MODELS:
        raise SystemExit(f"unknown model {name!r}; choose from {list(MODELS)}")
    return MODELS[name]


def cmd_graphgen(args) -> None:
    from deeprank_gnn_tpu_torch.featurize.graphgen import GraphHDF5

    GraphHDF5(
        pdb_path=args.pdb,
        ref_path=args.ref,
        pssm_path=args.pssm,
        graph_type=args.graph_type,
        outfile=args.out,
        nproc=args.nproc,
        biopython=args.biopython,
        limit=args.limit,
        device=args.device,
    )
    print(f"wrote {args.out}")


def _common_nn(args, pretrained=None):
    from deeprank_gnn_tpu_torch import NeuralNet

    return NeuralNet(
        args.database,
        _model_cls(args.model),
        node_feature=args.node_feature.split(","),
        edge_feature=args.edge_feature.split(","),
        target=args.target,
        task=args.task,
        lr=args.lr,
        batch_size=args.batch_size,
        percent=[1.0 - args.val_fraction, args.val_fraction],
        cluster_nodes=args.cluster,
        pretrained_model=pretrained,
        outdir=args.outdir,
        layout=args.layout,
        device_cache=getattr(args, "device_cache", False),
        scan_epochs=getattr(args, "scan_epochs", False),
        store_pack=getattr(args, "store_pack", "lossless"),
        dense_fast=getattr(args, "dense_fast", False),
        device=args.device,
    )


def cmd_train(args) -> None:
    nn = _common_nn(args)
    nn.train(
        nepoch=args.epochs,
        validate=args.val_fraction > 0,
        save_model=args.save_model,
    )
    print("final train loss:", nn.train_loss[-1])


def cmd_test(args) -> None:
    from deeprank_gnn_tpu_torch import NeuralNet

    nn = NeuralNet(
        args.database,
        _model_cls(args.model),
        pretrained_model=args.checkpoint,
        outdir=args.outdir,
        device=args.device,
    )
    nn.test(threshold=args.threshold)
    for mol, pred in zip(nn.data["test"]["mol"], nn.data["test"]["outputs"]):
        print(mol, pred)
    if nn.test_y is not None:
        print("test loss:", nn.test_loss)


def cmd_add_target(args) -> None:
    from deeprank_gnn_tpu_torch.tools import add_target

    add_target(args.hdf5, args.name, args.target_list)


def cmd_hdf5_to_csv(args) -> None:
    from deeprank_gnn_tpu_torch.tools import hdf5_to_csv

    print(hdf5_to_csv(args.hdf5))


def _device_arg(s, what: str) -> None:
    s.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help=f"where {what} runs: the CUDA card, or the CPU (where the "
        "hand kernels run their plain versions)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deeprank_gnn_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("graphgen", help="featurize PDBs into graph HDF5")
    g.add_argument("--pdb", required=True)
    g.add_argument("--ref", default=None)
    g.add_argument("--pssm", default=None)
    g.add_argument("--out", default="graph.hdf5")
    g.add_argument("--nproc", type=int, default=1)
    g.add_argument(
        "--graph-type", default="residue", choices=("residue", "atomic"),
        help="node resolution: interface residues (reference behavior) "
        "or heavy interface atoms",
    )
    g.add_argument("--biopython", action="store_true")
    g.add_argument("--limit", type=int, default=None)
    _device_arg(g, "the featurizer's geometry")
    g.set_defaults(fn=cmd_graphgen)

    def nn_args(s):
        s.add_argument("--database", required=True)
        s.add_argument("--model", default="GINet")
        s.add_argument("--outdir", default="./")
        _device_arg(s, "the model")

    t = sub.add_parser("train", help="train a model")
    nn_args(t)
    t.add_argument("--node-feature", default="type,polarity,bsa,charge,cons,ic,pssm")
    t.add_argument("--edge-feature", default="dist")
    t.add_argument("--target", default="irmsd")
    t.add_argument("--task", default=None)
    t.add_argument("--lr", type=float, default=0.001)
    t.add_argument("--batch-size", type=int, default=128)
    t.add_argument("--val-fraction", type=float, default=0.2)
    t.add_argument("--cluster", default="mcl")
    t.add_argument("--epochs", type=int, default=50)
    t.add_argument("--save-model", default="best")
    t.add_argument("--layout", default="sparse")
    t.add_argument(
        "--device-cache", action="store_true",
        help="upload the dense-collated dataset to HBM once "
        "(requires --layout dense)",
    )
    t.add_argument(
        "--scan-epochs", action="store_true",
        help="roll each epoch into one compiled execution "
        "(requires --device-cache)",
    )
    t.add_argument(
        "--store-pack", default="lossless", choices=("lossless", "bf16"),
        help="device-store payload packing (bf16 halves fp32 bytes)",
    )
    t.add_argument(
        "--dense-fast", action="store_true",
        help="GINet's dense aggregations with bf16 operands and fp32 "
        "accumulation (requires --layout dense)",
    )
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("test", help="score graphs with a checkpoint")
    nn_args(e)
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--threshold", type=float, default=4.0)
    e.set_defaults(fn=cmd_test)

    a = sub.add_parser("add-target", help="inject custom targets")
    a.add_argument("hdf5")
    a.add_argument("name")
    a.add_argument("target_list")
    a.set_defaults(fn=cmd_add_target)

    c = sub.add_parser("hdf5-to-csv", help="convert epoch outputs to CSV")
    c.add_argument("hdf5")
    c.set_defaults(fn=cmd_hdf5_to_csv)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

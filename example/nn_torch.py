"""Train a GINet scorer on featurized graphs, with the PyTorch port.

The port's counterpart of ``nn.py`` (reference `example/nn.py`).

    python example/nn_torch.py                    # on the card
"""

from deeprank_gnn_tpu_torch import GINet, NeuralNet

database = "./1ATN_residue.hdf5"


def main(database=database, nepoch=250, device="cuda", outdir="./"):
    """Train on ``database`` for ``nepoch`` epochs, plot predictions
    against targets into ``outdir``; returns the engine."""
    nn = NeuralNet(
        database,
        GINet,
        node_feature=["type", "polarity", "bsa", "depth", "hse", "ic", "pssm"],
        edge_feature=["dist"],
        target="irmsd",
        index=None,
        task="reg",
        batch_size=64,
        percent=[0.8, 0.2],
        outdir=outdir,
        device=device,
    )
    nn.train(nepoch=nepoch, validate=False)
    nn.plot_scatter()
    return nn


if __name__ == "__main__":
    main()

"""h5xplorer application launcher (reference `h5x/h5x.py:1-11`).

Requires the optional `h5xplorer` + PyQt5 stack; raises a clear error
when missing (these are GUI-only dependencies).

The port's own copy of ``deeprank_gnn_tpu/h5x/h5x.py``.
"""

import os


def main():
    try:
        from h5xplorer.h5xplorer import h5xplorer
    except ImportError as exc:  # pragma: no cover - GUI optional
        raise ImportError(
            "h5xplorer (and PyQt5) are required for the HDF5 explorer GUI: "
            "pip install h5xplorer"
        ) from exc
    from deeprank_gnn_tpu_torch.h5x import h5x_menu

    base = os.path.dirname(os.path.abspath(__file__))
    app = h5xplorer(
        h5x_menu.context_menu, baseimport=os.path.join(base, "baseimport.py"),
        extended_selection=False,
    )
    return app


if __name__ == "__main__":  # pragma: no cover
    main()

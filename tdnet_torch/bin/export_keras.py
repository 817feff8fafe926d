"""Export a ``.tdn`` bundle's weights to a keras-retinanet-layout ``.h5``,
the counterpart of ``tdnet/bin/export_keras.py``:

    python -m tdnet_torch.bin.export_keras model.tdn weights.h5

The reverse of ``--weights model.h5``: trained weights flow back to the
reference's ecosystem. Layer names follow
``compat/keras_import.keras_name_map_for`` (SE-ResNet has no verified map
and raises, as in the reference); the file is written by the port's own
HDF5 writer (``compat/hdf5.py``), dataset for dataset the reference's.
"""

from __future__ import annotations

import argparse

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Export tdnet weights to a Keras-layout h5."
    )
    parser.add_argument("model", help=".tdn model bundle")
    parser.add_argument("h5_out", help="output .h5 path")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from tdnet_torch.bin._common import ensure_parent_dir
    from tdnet_torch.compat.keras_import import export_random_keras_weights, keras_name_map_for
    from tdnet_torch.models.io import load_model

    model, variables, _ = load_model(args.model)
    name_map = keras_name_map_for(model.backbone_name)
    ensure_parent_dir(args.h5_out)
    export_random_keras_weights(args.h5_out, variables, name_map=name_map)
    print(f"exported {args.model} ({model.backbone_name}) -> {args.h5_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

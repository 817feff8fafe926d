"""Packaging for tdnet (reference: keras-retinanet setup.py — cythonized
compute_overlap + retinanet-* console scripts).

tdnet's native component self-builds via ctypes on first import
(tdnet/native/__init__.py), so there is no build-time extension step; an
optional `python setup.py build_native` target pre-builds it.

Install (no network): pip install -e . --no-build-isolation --no-deps
"""

from setuptools import Command, find_packages, setup


class BuildNative(Command):
    description = "pre-build the native compute_overlap shared library"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        from tdnet.native import _load

        lib = _load()
        if lib is None:
            raise RuntimeError("native build failed (g++ unavailable?)")
        print("native compute_overlap built")


setup(
    name="tdnet",
    version="0.1.0",
    description="TPU-native RetinaNet for table detection (JAX/Pallas/pjit)",
    packages=find_packages(include=["tdnet", "tdnet.*",
                                    "tdnet_torch", "tdnet_torch.*"]),
    package_data={"tdnet.native": ["*.cpp"],
                  "tdnet_torch": ["csrc/*.cu", "csrc/*.cuh", "utils/*.npz"]},
    python_requires=">=3.10",
    cmdclass={"build_native": BuildNative},
    entry_points={
        "console_scripts": [
            # tdnet-native names
            "tdnet-train=tdnet.bin.train:main",
            "tdnet-evaluate=tdnet.bin.evaluate:main",
            "tdnet-convert-model=tdnet.bin.convert_model:main",
            "tdnet-debug=tdnet.bin.debug:main",
            "tdnet-predict=tdnet.bin.predict:main",
            "tdnet-export-keras=tdnet.bin.export_keras:main",
            "tdnet-csv-from-xml=tdnet.bin.csv_from_xml:main",
            "tdnet-serve=tdnet.bin.serve:main",
            # the PyTorch + CUDA port
            "tdnet-torch-serve=tdnet_torch.bin.serve:main",
            "tdnet-torch-predict=tdnet_torch.bin.predict:main",
            "tdnet-torch-evaluate=tdnet_torch.bin.evaluate:main",
            "tdnet-torch-train=tdnet_torch.bin.train:main",
            "tdnet-torch-convert-model=tdnet_torch.bin.convert_model:main",
            "tdnet-torch-export-keras=tdnet_torch.bin.export_keras:main",
            "tdnet-torch-csv-from-xml=tdnet_torch.bin.csv_from_xml:main",
            "tdnet-torch-debug=tdnet_torch.bin.debug:main",
            # reference-compatible aliases (keras-retinanet console scripts)
            "retinanet-train=tdnet.bin.train:main",
            "retinanet-evaluate=tdnet.bin.evaluate:main",
            "retinanet-convert-model=tdnet.bin.convert_model:main",
            "retinanet-debug=tdnet.bin.debug:main",
        ]
    },
)

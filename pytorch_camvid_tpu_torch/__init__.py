"""PyTorch/CUDA port of pytorch_camvid_tpu for NVIDIA Hopper (H100).

The JAX package ``pytorch_camvid_tpu`` is the reference; this package
mirrors its module names so each counterpart is easy to find, and never
imports jax. Public functions take and return NHWC tensors, as the JAX ones
do. Every TPU (Pallas) kernel on a ported path becomes a hand-written Hopper
kernel under ``csrc/``, built at first use; its plain PyTorch version sits in
the same module and serves CPU tensors. ROADMAP.md lists what is ported.

Ported so far: UNet serving (``serving.Predictor``, ``serve.py``), with every
conv3x3+BN+ReLU block on the fused kernel ``ops/fused_conv.py``; and the UNet
training step (``train.make_train_step``, ``bench.measure_train``), with
every conv3x3 on the training kernels of ``ops/conv_train.py``.
"""

__version__ = "0.1.0"

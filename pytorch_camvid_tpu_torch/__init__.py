"""PyTorch/CUDA port of pytorch_camvid_tpu for NVIDIA Hopper (H100).

The JAX package ``pytorch_camvid_tpu`` is the reference; this package
mirrors its module names so each counterpart is easy to find, and never
imports jax. Public functions take and return NHWC tensors, as the JAX ones
do. Every TPU (Pallas) kernel on a ported path becomes a hand-written Hopper
kernel under ``csrc/``, built at first use; its plain PyTorch version sits in
the same module and serves CPU tensors. ROADMAP.md lists what is ported.

Ported so far: UNet and SegNet serving (``serving.Predictor``, ``serve.py``),
with every conv3x3+BN+ReLU block on the fused kernel ``ops/fused_conv.py``
and SegNet's pools on ``ops/fused_pool.py`` (K3); and the UNet and SegNet
training steps (``train.make_train_step``, ``bench.measure_train``), with
every conv3x3 on the training kernels of ``ops/conv_train.py`` and SegNet's
pools on the phase pair of ``ops/fused_pool.py`` (K2); and the training run
around them: the epoch loop with its eval pass, checkpoints and resume
(``train/loop.py``, ``train/checkpoint.py``) and the train, eval, predict
and bench entry points (``python -m pytorch_camvid_tpu_torch.train``,
``.eval``, ``.predict``, ``.bench``); and the data side: the VOC reader
(``data/voc2012.py``), the host-fed ``HostLoader`` over the native gather
(``data/pipeline.py``, ``data/native.py``), every augmentation of the JAX
package (``data/augment.py``, ``data/transforms.py``), the LR finder
(``.lr_finder``) and the dataset statistics (``.compute_stats``).
"""

__version__ = "0.1.0"

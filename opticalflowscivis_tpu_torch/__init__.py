"""opticalflowscivis_tpu_torch — PyTorch + CUDA port of ``opticalflowscivis_tpu``.

The JAX package beside this one is the reference; this package mirrors its
module layout so that each counterpart is found under the same path:

- ``ops``        — plain PyTorch warp / resize / cost volume / occlusion /
  census / SSIM, and ``ops.kernels``: the hand-written Hopper kernels (CUDA
  C++ in ``csrc/``) with their wrappers.
- ``models``     — IFNet (RIFE student/teacher), 2-D and 3-D, with its
  Contextnet/Unet refinement, UPFlowNet (pyramid flow network), and the
  pretrained RIFE zoo networks (HDv3, HD v1 / v2) with their loaders, as
  ``nn.Module``s.
- ``bridge``     — flax params → this package's ``state_dict``s.
- ``losses``     — the RIFE training losses, the UPFlow unsupervised losses,
  the self-supervised transform losses and the VGG perceptual loss.
- ``training``   — config, schedule, checkpoint, the ``Trainer`` and the
  ``UPFlowTrainer``.
- ``cli``        — the verbs: generate, train, test, inference_img / _video,
  train_upflow, test_upflow (SciVis datasets and KITTI), select.
- ``scripts``    — ``train256`` (256³ training) and ``forward3d`` (forward timing).
- ``inference``  — ``Interpolator`` and the series / recursive interpolators,
  ``ZooInterpolator`` and ``load_pretrained_zoo``.
- ``evalsuite``  — PSNR / SSIM metrics, the linear baseline, flow EPE / F1,
  time-step selection.
- ``data``       — numpy generators, pipeline, dataset registry, the KITTI
  readers, samplers and frame store.
- ``viz``        — flow colourings and the matplotlib panels.
- ``utils``      — profiling (``trace``, the ``ofs.`` spans), ``check_tensor``.

Conventions at the public functions are the reference's: channels-last
arrays and row-major flow, (dy, dx) in 2-D and (dz, dy, dx) in 3-D.
Inside ``nn.Module``s tensors are channels-first.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; they raise when CUDA is asked for and
absent (``device.resolve_device``).

This package imports torch, numpy and the standard library — never jax, flax
or ``opticalflowscivis_tpu`` — and, inside the functions that need them, cv2
(KITTI's PNGs) and matplotlib (``viz``).
"""

__version__ = "0.1.0"

"""Command-line entry points of the port.

Verbs, with the flags of ``opticalflowscivis_tpu.cli``:
  generate         write a synthetic dataset's pickle
  train            RIFE training (``Trainer.fit``)
  test             batch inference on the test split + report
  inference_img    interpolate between two images
  inference_video  multi-factor interpolation of the test series + report

They run on the GPU unless ``--cpu`` is given.  The verbs and datasets that
wait for later slices exit with a message naming their ROADMAP item.

Run: ``python -m opticalflowscivis_tpu_torch.cli <verb> [flags]``.
"""

"""Plain PyTorch reference of the detector: forward, decode, targets, loss
and optimizer, in float32 with TF32 off. It imports nothing of the program.

Each configuration file names its forward reference by the top-level key
``"reference"``: a module of this package (``model`` for the EfficientNet-B0
detectors, ``resnet`` for the ResNet ones), which ``harness/cell.find``
resolves and hands to everything that builds weights, counts work or
computes the reference's side of a comparison. A new trunk or head is a new
module here, named in its configuration file; nothing else changes.

What such a module exports (``CONTRACT``):

* ``param_specs(m)``: (name, shape, kind) of every weight the program's
  artifact loads, in the order the weights are drawn, for ``m`` the
  config's MODEL section with VIEWS added (kinds: ``inputs.make_weights``);
* ``Reference(cfg, weights, q)``: the detector, with ``forward(images, K,
  Rt, train=False)`` (the head's logits and maps, channels-last),
  ``feature_hw()``, ``bev_hw``, ``img_hw``, ``bounds``, ``batch_stats(images)``
  (every BatchNorm's batch mean and biased variance over uint8 frames [N,
  H, W, 3], by the norm's parameter prefix) and, for ``FUSION:
  deform_attn``, ``encode`` and ``deform_inputs`` and ``sampling``;
* ``project_cells``, ``normalise``, ``tf32_off``: the ground-plane
  geometry, the frames' normalisation, and TF32 switched off.
"""

CONTRACT = ("param_specs", "Reference", "project_cells", "normalise", "tf32_off")

"""perception_tpu_torch: the PyTorch + CUDA port of perception_tpu.

The JAX package ``perception_tpu`` is the reference; this package keeps
its module paths and function names and imports neither jax nor
anything of ``perception_tpu``. Importing it builds nothing: the CUDA
kernels under ``csrc/`` are compiled at first use on a CUDA tensor
(``ops/kernels/build.py``).

Ported so far: the cuboid pipeline (``models/cuboid.py``), SLAM
odometry (``models/slam/odometry.py``) and the keyframe SLAM system on it
(``models/slam/system.py``, ``models/slam/backend.py``), the detection
service and tracker (``models/objects.py``, ``models/object_tracking.py``),
the CNN facade (``wrapper.py``'s ``Perception`` over ``models/pose.py``,
``models/hand.py``, the face family ``models/face*.py`` and their
fixtures, read by ``io/flax_msgpack.py``) and person tracking
(``models/tracking.py`` on ``ops/lk.py``), the command line (``cli.py``)
and its file I/O, the leaf nodes and the 3-D chain, training
(``models/train.py``, the training batches of ``models/*_data.py``, the
fixtures' ``init_tiny`` and ``save_fixture``, ``jax.random``'s key
stream in numpy in ``utils/jax_random.py``), checkpoints
(``utils/checkpoint.py``) and the roofline accounting
(``utils/roofline.py``), the multi-device layer on ``torch.distributed``
(``parallel/``: the rank mesh, distributed ICP, BA and pose graphs,
map-sharded odometry, data-parallel training, the multi-process runtime
and its dry run), the display, codec and device leaves (``io/imgcodec.py``,
``io/colors.py``, ``models/viz.py``'s depth colouring and 3-D viewer on
the card, ``io/gui.py``'s ``Gui3D``, the COCO and heatmap savers, the
camera readers), with what they run, including the three kernels
under ``csrc/``: fused RANSAC scoring, the fused Gauss-Newton ICP system
and the voxel-hash query. The repository's ``examples_torch/`` tour it.
"""

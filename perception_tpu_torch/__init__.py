"""perception_tpu_torch: the PyTorch + CUDA port of perception_tpu.

The JAX package ``perception_tpu`` is the reference; this package keeps
its module paths and function names and imports neither jax nor
anything of ``perception_tpu``. Importing it builds nothing: the CUDA
kernels under ``csrc/`` are compiled at first use on a CUDA tensor
(``ops/kernels/build.py``).

Ported so far: the cuboid pipeline (``models/cuboid.py``), SLAM
odometry (``models/slam/odometry.py``) and the keyframe SLAM system on it
(``models/slam/system.py``, ``models/slam/backend.py``), the detection
service and tracker (``models/objects.py``, ``models/object_tracking.py``)
and the pose and hand path of the CNN facade (``models/pose.py``,
``models/hand.py`` and their fixtures, read by ``io/flax_msgpack.py``),
with what they run, including the three kernels under ``csrc/``: fused
RANSAC scoring, the fused Gauss-Newton ICP system and the voxel-hash
query.
"""

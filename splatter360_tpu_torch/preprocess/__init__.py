"""Offline dataset synthesis: procedural RGB-D panorama scenes.

Counterpart of splatter360_tpu/preprocess/. The reference generates its
HM3D/Replica training data with Habitat-sim (navigable start/goal sampling,
shortest-path trajectories, per-frame cube-rig RGB-D renders stitched to
ERP, zero-ratio filtering); its scan assets are not redistributable, so this
package reproduces the pipeline on procedural rooms rendered with the port's
dense renderer:

  scene_builder  procedural room worlds as dense Gaussian surfaces (numpy)
  trajectory     free-space start/goal, BFS path, smoothed c2w poses (numpy)
  generate       direct-ERP or cube-rig renders on the card, the zero-ratio
                 filter, scenes written with data/scene_io.save_scene
  validate       cross-view RGB-D consistency of a stored scene (numpy)

The scenes have the data contract of the real datasets (ERP RGB u8, ERP
depth in mm u16, c2w poses), so mode=train and mode=test read them as they
are. `python -m splatter360_tpu_torch.preprocess` writes a dataset.
"""

from .generate import generate_scene  # noqa: F401
from .scene_builder import build_room_world  # noqa: F401
from .trajectory import sample_trajectory  # noqa: F401
from .validate import check_scene_consistency  # noqa: F401

from .se3 import (
    hat,
    vee,
    so3_exp,
    so3_log,
    se3_exp,
    se3_log,
    se3_compose,
    se3_inverse,
    se3_apply,
    sim3_compose,
    sim3_inverse,
    sim3_exp,
)
from .epipolar import (
    normalize_points,
    eight_point,
    essential_project,
    sampson_distance,
    ransac_essential,
    decompose_essential,
    recover_pose,
)
from .triangulate import triangulate_points
from .ba import two_view_ba, reprojection_residuals
from .mvba import (
    build_landmark_table,
    multi_view_ba,
    multi_view_ba_sharded,
    shard_ba_problem,
)
from .posegraph import (
    optimize_pose_graph,
    optimize_pose_graph_sim3,
    optimize_pose_graph_sharded,
    optimize_pose_graph_sim3_sharded,
)

__all__ = [
    "hat", "vee", "so3_exp", "so3_log", "se3_exp", "se3_log",
    "se3_compose", "se3_inverse", "se3_apply",
    "normalize_points", "eight_point", "essential_project",
    "sampson_distance", "ransac_essential", "decompose_essential",
    "recover_pose",
    "triangulate_points",
    "two_view_ba", "reprojection_residuals",
    "build_landmark_table", "multi_view_ba", "multi_view_ba_sharded",
    "shard_ba_problem",
    "optimize_pose_graph", "optimize_pose_graph_sim3",
    "optimize_pose_graph_sharded", "optimize_pose_graph_sim3_sharded",
    "sim3_compose", "sim3_inverse", "sim3_exp",
]

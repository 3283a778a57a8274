"""SE3 <-> ROS geometry_msgs conversions: the port's copy of
``object_keypoints_tpu/utils/ros.py`` (reference perception/utils/
ros.py:5-41).

Works with real geometry_msgs when ROS is installed; otherwise falls back
to lightweight structural stand-ins with the same attribute layout so the
conversion logic (and its tests, reference test/utils/test_ros.py) run in
ROS-free environments.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

try:  # pragma: no cover - exercised only on ROS installs
    from geometry_msgs import msg as geometry_msgs

    HAVE_ROS = True
except ImportError:
    HAVE_ROS = False

    class _Struct:
        """Attribute bag mirroring a ROS message's field layout."""

        def __init__(self, **fields):
            for k, v in fields.items():
                setattr(self, k, v)

    class _Msgs:
        @staticmethod
        def TransformStamped():
            return _Struct(
                header=_Struct(stamp=None, frame_id=""),
                child_frame_id="",
                transform=_Struct(
                    translation=_Struct(x=0.0, y=0.0, z=0.0),
                    rotation=_Struct(x=0.0, y=0.0, z=0.0, w=1.0),
                ),
            )

        @staticmethod
        def PoseStamped():
            return _Struct(
                header=_Struct(stamp=None, frame_id=""),
                pose=_Struct(
                    position=_Struct(x=0.0, y=0.0, z=0.0),
                    orientation=_Struct(x=0.0, y=0.0, z=0.0, w=1.0),
                ),
            )

    geometry_msgs = _Msgs()


def message_to_transform(message):
    T = np.eye(4)
    t = message.transform.translation
    r = message.transform.rotation
    T[:3, 3] = [t.x, t.y, t.z]
    T[:3, :3] = Rotation.from_quat([r.x, r.y, r.z, r.w]).as_matrix()
    return T


def transform_to_message(T, parent_frame, child_frame, timestamp):
    msg = geometry_msgs.TransformStamped()
    msg.header.stamp = timestamp
    msg.header.frame_id = parent_frame
    msg.child_frame_id = child_frame
    msg.transform.translation.x = T[0, 3]
    msg.transform.translation.y = T[1, 3]
    msg.transform.translation.z = T[2, 3]
    q = Rotation.from_matrix(T[:3, :3]).as_quat()
    msg.transform.rotation.x = q[0]
    msg.transform.rotation.y = q[1]
    msg.transform.rotation.z = q[2]
    msg.transform.rotation.w = q[3]
    return msg


def transform_to_pose(T, frame, timestamp):
    msg = geometry_msgs.PoseStamped()
    msg.header.stamp = timestamp
    msg.header.frame_id = frame
    msg.pose.position.x = T[0, 3]
    msg.pose.position.y = T[1, 3]
    msg.pose.position.z = T[2, 3]
    q = Rotation.from_matrix(T[:3, :3]).as_quat()
    msg.pose.orientation.x = q[0]
    msg.pose.orientation.y = q[1]
    msg.pose.orientation.z = q[2]
    msg.pose.orientation.w = q[3]
    return msg

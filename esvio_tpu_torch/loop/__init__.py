"""Loop closure: FAST + BRIEF keyframe features, the keyframe database,
PnP verification and the 4-DoF pose graph (port of esvio_tpu/loop)."""

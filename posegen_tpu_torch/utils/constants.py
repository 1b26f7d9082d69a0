"""Joint maps and normalization constants (the port's copy of
posegen_tpu/utils/constants.py).

Capability parity with reference core/utils/constants.py:1-151 (the SPIN
joint conventions: 49-joint output = 25 OpenPose + 24 extra, H36M regressor
index maps, image normalization).
"""

IMG_NORM_MEAN = [0.485, 0.456, 0.406]
IMG_NORM_STD = [0.229, 0.224, 0.225]
IMG_RES = 224
FOCAL_LENGTH = 5000.0

# H36M 17-joint regressor output -> the 17/14 joint eval subsets
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]

# SPIN's 49-joint layout: 25 OpenPose joints then 24 "ground-truth" joints
JOINT_NAMES_49 = [
    # 25 OpenPose
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar", "OP LBigToe",
    "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
    # 24 extra
    "Right Ankle", "Right Knee", "Right Hip", "Left Hip", "Left Knee",
    "Left Ankle", "Right Wrist", "Right Elbow", "Right Shoulder",
    "Left Shoulder", "Left Elbow", "Left Wrist", "Neck (LSP)",
    "Top of Head (LSP)", "Pelvis (MPII)", "Thorax (MPII)", "Spine (H36M)",
    "Jaw (H36M)", "Head (H36M)", "Nose", "Left Eye", "Right Eye",
    "Left Ear", "Right Ear",
]

# index of the SPIN joint used to align SPIN predictions to the NeRF world
# (reference process_spin.py align_joint_idx=8: OP MidHip)
SPIN_ALIGN_JOINT = 8

# 3DPW sequence names used by the eval harness (reference constants)
PW3D_TEST_SEQS = [
    "downtown_enterShop_00",
    "downtown_rampAndStairs_00",
    "flat_packBags_00",
    "downtown_runForBus_00",
    "office_phoneCall_00",
    "downtown_windowShopping_00",
    "downtown_walkUphill_00",
    "downtown_sitOnStairs_00",
    "downtown_walking_00",
    "downtown_crossStreets_00",
    "downtown_walkBridge_01",
    "downtown_weeklyMarket_00",
    "downtown_warmWelcome_00",
    "downtown_arguing_00",
    "downtown_upstairs_00",
    "flat_guitar_01",
    "downtown_runForBus_01",
    "downtown_stairs_00",
    "downtown_bar_00",
    "downtown_cafe_00",
    "downtown_bus_00",
    "downtown_downstairs_00",
]

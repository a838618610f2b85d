from rnntransducer_tpu_torch.models.cells import RNNLayer, RNNState, StackedRNN
from rnntransducer_tpu_torch.models.conformer import ConformerEncoder
from rnntransducer_tpu_torch.models.encoder import AudioEncoder, stack_frames
from rnntransducer_tpu_torch.models.joint import JointNetwork
from rnntransducer_tpu_torch.models.prednet import PredictionNet
from rnntransducer_tpu_torch.models.transducer import RNNTransducer, build_model

__all__ = ["AudioEncoder", "ConformerEncoder", "JointNetwork", "PredictionNet",
           "RNNLayer", "RNNState", "RNNTransducer", "StackedRNN", "build_model",
           "stack_frames"]

from rnntransducer_tpu_torch.decode.beam import BeamSearchDecoder
from rnntransducer_tpu_torch.decode.beam_batched import batched_beam_decode
from rnntransducer_tpu_torch.decode.device_lm import DeviceCharLM
from rnntransducer_tpu_torch.decode.greedy import (
    GreedyCarry, greedy_decode, greedy_decode_frames, greedy_decode_label_looping,
    greedy_decode_with_times, init_greedy_carry,
)
from rnntransducer_tpu_torch.decode.hotwords import HotwordScorer
from rnntransducer_tpu_torch.decode.session_batch import BatchedSession, BatchedStreamingRunner
from rnntransducer_tpu_torch.decode.streaming import StreamingFrontend, StreamingRecognizer

__all__ = ["BeamSearchDecoder", "batched_beam_decode", "GreedyCarry", "greedy_decode",
           "greedy_decode_frames", "greedy_decode_label_looping",
           "greedy_decode_with_times", "init_greedy_carry", "HotwordScorer",
           "DeviceCharLM", "StreamingFrontend", "StreamingRecognizer",
           "BatchedSession", "BatchedStreamingRunner"]

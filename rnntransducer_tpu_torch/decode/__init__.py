from rnntransducer_tpu_torch.decode.greedy import (
    GreedyCarry, greedy_decode, greedy_decode_frames, greedy_decode_label_looping,
    greedy_decode_with_times, init_greedy_carry,
)

__all__ = ["GreedyCarry", "greedy_decode", "greedy_decode_frames",
           "greedy_decode_label_looping", "greedy_decode_with_times",
           "init_greedy_carry"]

"""``decode_mfu`` in the open-loop cell, where it moves ``ttft_p90_s``: the engine
waits for the decode block in flight before each admission, and a request's
first token comes with the first decode block after it. (That cell reports
no TPOT: its p90 spread 11-14 % over runs of one schedule.)"""

from perfbench.spec import metric_reader

read = metric_reader("decode_mfu")

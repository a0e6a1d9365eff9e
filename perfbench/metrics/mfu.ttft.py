"""The model step's share of the card's bf16 peak in the chat pool: 2·N
FLOPs (``counters.decode_flops_per_token``) for every token the window
passed through the model, the prompt tokens the radix cache did not
supply and one token a decode step of each live row, over the window."""
from perfbench.counters import decode_flops_per_token
from perfbench.readers import mfu


def read(r):
    c = r.counters
    tokens = (c["prompt_tokens"] - c["cached_tokens_saved"]
              + c["generated"] - c["admitted"])
    return mfu(r, tokens * decode_flops_per_token(r.config))

"""Host helpers of the port. ``inline_bpe_tokenizer`` is the dev tokenizer
(a tiny real BPE, or a byte stub without ``tokenizers``), re-exported for
checkpoint-free runs."""

from flux2_tpu_torch.utils.dev_tokenizer import inline_bpe_tokenizer

__all__ = ["inline_bpe_tokenizer"]

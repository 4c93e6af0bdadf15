"""The port's model families, their configurations, and weight
conversion: ``DecoderLM`` (LLaMA-family causal LM), ``Seq2SeqLM`` (T5
family) and ``EncoderClassifier`` (BERT family)."""

from .configs import DecoderConfig, EncoderConfig
from .decoder import DecoderLM
from .encoder import EncoderClassifier
from .seq2seq import Seq2SeqConfig, Seq2SeqLM, shift_right

__all__ = ["DecoderConfig", "DecoderLM", "EncoderClassifier", "EncoderConfig",
           "Seq2SeqConfig", "Seq2SeqLM", "shift_right"]

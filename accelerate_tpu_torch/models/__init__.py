"""The port's model families, their configurations, and weight
conversion: ``DecoderLM`` (LLaMA-family causal LM, dense or MoE),
``Seq2SeqLM`` (T5 family), ``EncoderClassifier`` (BERT family) and
``ResNet`` (image classifier)."""

from .configs import DecoderConfig, EncoderConfig, VisionConfig
from .decoder import DecoderLM
from .encoder import EncoderClassifier
from .moe import MoeMLP
from .seq2seq import Seq2SeqConfig, Seq2SeqLM, shift_right
from .vision import ResNet

__all__ = ["DecoderConfig", "DecoderLM", "EncoderClassifier", "EncoderConfig", "MoeMLP",
           "ResNet", "Seq2SeqConfig", "Seq2SeqLM", "VisionConfig", "shift_right"]

from dafne_torch.evaluation.evaluator import RotatedDetectionEvaluator, build_evaluator

__all__ = ["RotatedDetectionEvaluator", "build_evaluator"]

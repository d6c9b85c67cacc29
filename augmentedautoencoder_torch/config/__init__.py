"""Config system: .cfg files with the reference's section/key grammar.

The reference drives everything through configparser .cfg files and `eval()`s
expression-valued entries (lists, camera K with arithmetic, and the whole
imgaug pipeline — auto_pose/ae/ae_factory.py:35-37, auto_pose/ae/dataset.py:380-390).
We keep the exact file grammar but replace `eval` with a restricted AST
evaluator (`safe_eval`) and parse the augmentation DSL into typed specs.
"""

from .eval_config import EvalConfig, load_eval_config
from .safe_eval import safe_eval
from .train_config import TrainConfig, load_train_config

__all__ = ["safe_eval", "EvalConfig", "load_eval_config", "TrainConfig", "load_train_config"]

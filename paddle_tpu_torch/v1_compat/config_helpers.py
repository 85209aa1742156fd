"""The ``paddle.trainer_config_helpers`` star-import surface for v1 config
files (reference: python/paddle/trainer_config_helpers/__init__.py re-exports
layers + activations + optimizers + poolings + networks + data_sources).

v1 configs do ``from paddle.trainer_config_helpers import *`` then call
`settings()`, `define_py_data_sources2()`, layer functions, and
`outputs()`; ``parse_config`` (v1_compat/__init__.py) installs this module
under that name, executes the config, and collects the declarations below.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

# Layer DSL + networks: configs use the *_layer names and the bare ones.
from paddle_tpu_torch.layers import *  # noqa: F401,F403
from paddle_tpu_torch.layers import layer_math  # noqa: F401
from paddle_tpu_torch.layers import LayerOutput, data as _data_fn
from paddle_tpu_torch.layers.networks import (  # noqa: F401
    bidirectional_gru,
    bidirectional_lstm,
    gru_group,
    gru_unit,
    img_conv_group,
    lstmemory_group,
    lstmemory_unit,
    sequence_conv_pool,
    simple_attention,
    simple_gru,
    simple_gru2,
    simple_img_conv_pool,
    simple_lstm,
    small_vgg,
    vgg_16_network,
)
from paddle_tpu_torch import evaluator as _ev
from paddle_tpu_torch import activation as _A
from paddle_tpu_torch import pooling as _P
from paddle_tpu_torch.v1_compat.raw_face import (  # noqa: F401
    Bias,
    ContextProjection,
    DotMulProjection,
    Evaluator,
    FullMatrixProjection,
    IdentityOffsetProjection,
    IdentityProjection,
    Input,
    Layer,
    Memory,
    RecurrentLayerGroupBegin,
    RecurrentLayerGroupEnd,
    TableProjection,
    TransposedFullMatrixProjection,
    model_type,
)
from paddle_tpu_torch.attr import ExtraAttr, ParamAttr
from paddle_tpu_torch.core import data_types as _dt

# -- v1 class-name aliases ---------------------------------------------------

# Activations (reference activations.py: <Name>Activation classes)
IdentityActivation = _A.Identity
LinearActivation = _A.Linear
SigmoidActivation = _A.Sigmoid
SoftmaxActivation = _A.Softmax
SequenceSoftmaxActivation = _A.SequenceSoftmax
ReluActivation = _A.Relu
BReluActivation = _A.BRelu
TanhActivation = _A.Tanh
STanhActivation = _A.STanh
SoftReluActivation = _A.SoftRelu
AbsActivation = _A.Abs
SquareActivation = _A.Square
ExpActivation = _A.Exp
LogActivation = _A.Log

# Poolings (reference poolings.py)
MaxPooling = _P.Max
AvgPooling = _P.Avg
SumPooling = _P.Sum
SquareRootNPooling = _P.SquareRootN
CudnnMaxPooling = _P.CudnnMax
CudnnAvgPooling = _P.CudnnAvg

# Attributes
ParameterAttribute = ParamAttr
ExtraLayerAttribute = ExtraAttr
ExtraAttribute = ExtraAttr

# conv_layer is the v1 name for img_conv
conv_layer = img_conv  # noqa: F405


def data_layer(
    name: str, size: int, height: int = 0, width: int = 0, layer_attr=None
) -> LayerOutput:
    """v1 data_layer: declares only a size; the slot's real input type comes
    from the data provider and is resolved by parse_config (reference
    config_parser.py DataLayer + DataProvider ownership of types)."""
    lo = _data_fn(name, _dt.dense_vector(size), height=height, width=width)
    lo.conf.attrs["_v1_size_only"] = True
    return lo


# -- optimizers (reference trainer_config_helpers/optimizers.py) -------------


class BaseSGDOptimizer:
    """Carries the learning-method choice; settings() maps it (plus the
    shared learning-rate/regularization arguments) onto paddle_tpu.optimizer
    classes via make_optimizer."""

    kind = "sgd"
    extra: Dict[str, Any] = {}


class MomentumOptimizer(BaseSGDOptimizer):
    kind = "momentum"

    def __init__(self, momentum: float = 0.9, sparse: bool = False):
        self.extra = {"momentum": momentum}


class AdamOptimizer(BaseSGDOptimizer):
    kind = "adam"

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8):
        self.extra = {"beta1": beta1, "beta2": beta2, "epsilon": epsilon}


class AdamaxOptimizer(BaseSGDOptimizer):
    kind = "adamax"

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999):
        self.extra = {"beta1": beta1, "beta2": beta2}


class AdaGradOptimizer(BaseSGDOptimizer):
    kind = "adagrad"

    def __init__(self):
        self.extra = {}


class DecayedAdaGradOptimizer(BaseSGDOptimizer):
    kind = "decayed_adagrad"

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        self.extra = {"rho": rho, "epsilon": epsilon}


class AdaDeltaOptimizer(BaseSGDOptimizer):
    kind = "adadelta"

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        self.extra = {"rho": rho, "epsilon": epsilon}


class RMSPropOptimizer(BaseSGDOptimizer):
    kind = "rmsprop"

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        self.extra = {"rho": rho, "epsilon": epsilon}


class BaseRegularization:
    pass


class L2Regularization(BaseRegularization):
    def __init__(self, rate: float):
        self.rate = rate


class L1Regularization(BaseRegularization):
    def __init__(self, rate: float):
        self.rate = rate


class ModelAverage:
    def __init__(self, average_window: float, max_average_window: Optional[int] = None):
        self.average_window = average_window
        self.max_average_window = max_average_window


# -- parse-time collected state ----------------------------------------------


@dataclasses.dataclass
class TrainerSettings:
    """What settings() declared (reference optimizers.py:358)."""

    batch_size: int = 1
    learning_rate: float = 1e-3
    learning_rate_decay_a: float = 0.0
    learning_rate_decay_b: float = 0.0
    learning_rate_schedule: str = "constant"
    # 'seg0:rate0,seg1:rate1,...' for manual/pass_manual
    # (LearningRateScheduler.cpp ManualLRS)
    learning_rate_args: str = ""
    learning_method: Optional[BaseSGDOptimizer] = None
    regularization: Optional[BaseRegularization] = None
    model_average: Optional[ModelAverage] = None
    gradient_clipping_threshold: float = 0.0
    is_async: bool = False


@dataclasses.dataclass
class DataSources:
    """What define_py_data_sources2 declared (reference data_sources.py:158)."""

    train_list: Optional[str] = None
    test_list: Optional[str] = None
    module: Optional[str] = None
    obj: Optional[str] = None
    test_obj: Optional[str] = None
    args: Optional[dict] = None
    # split datasource: a different provider module for the test stream
    test_module: Optional[str] = None


class _ParseState:
    def __init__(self, config_args: Dict[str, str]):
        self.config_args = config_args
        self.settings = TrainerSettings()
        self.data_sources: Optional[DataSources] = None
        self.train_data: Optional[DataConfig] = None
        self.test_data: Optional[DataConfig] = None
        self.inputs: List[LayerOutput] = []
        self.outputs: List[LayerOutput] = []
        self.evaluators: List[Any] = []
        self.input_names: List[str] = []
        self.pending_output_names: List[str] = []
        self.all_layers: Dict[str, LayerOutput] = {}
        # model_type('multi_nn') ensembles (reference MultiNetwork.cpp,
        # ModelConfig.proto:579 SubModelConfig): each SubModelBegin/End
        # block records its own Inputs/Outputs
        self.model_type_name: Optional[str] = None
        self.submodels: List[dict] = []
        self.submodel_stack: List[dict] = []


_state: Optional[_ParseState] = None


def _require_state() -> _ParseState:
    assert _state is not None, (
        "v1 config helpers must run under paddle_tpu.v1_compat.parse_config"
    )
    return _state


def get_config_arg(name: str, type_, default=None):
    """reference config_parser.py:3581 — typed lookup into the
    ``--config_args`` k=v list given to parse_config."""
    st = _require_state()
    if name not in st.config_args:
        return default
    v = st.config_args[name]
    if type_ is bool:
        return str(v).lower() in ("1", "true", "yes")
    return type_(v)


def settings(batch_size, **kw):
    st = _require_state()
    s = st.settings
    s.batch_size = batch_size
    for k, v in kw.items():
        if not hasattr(s, k):
            raise TypeError(f"settings() got unexpected argument {k!r}")
        setattr(s, k, v)
    # poly schedule with zero decay is the reference default; treat as constant
    if s.learning_rate_schedule == "poly" and s.learning_rate_decay_a == 0.0:
        s.learning_rate_schedule = "constant"


_METHOD_BY_NAME = {
    "momentum": lambda: MomentumOptimizer(),
    "sgd": lambda: MomentumOptimizer(momentum=0.0),
    "adam": lambda: AdamOptimizer(),
    "adamax": lambda: AdamaxOptimizer(),
    "adagrad": lambda: AdaGradOptimizer(),
    "decayed_adagrad": lambda: DecayedAdaGradOptimizer(),
    "adadelta": lambda: AdaDeltaOptimizer(),
    "rmsprop": lambda: RMSPropOptimizer(),
}


def Settings(batch_size=1, learning_rate=1e-3, algorithm="sgd", **kw):
    """The older capital-S config_parser.Settings() face (model_zoo-era
    configs): maps onto settings(); string learning_method names resolve to
    the optimizer classes; unrecognized knobs are ignored like the
    reference's tolerant kwargs handling."""
    st = _require_state()
    st.settings.batch_size = batch_size
    st.settings.learning_rate = learning_rate
    for k, v in kw.items():
        if k == "learning_method" and isinstance(v, str):
            if v not in _METHOD_BY_NAME:
                raise ValueError(
                    f"unknown learning_method {v!r}; supported: "
                    f"{sorted(_METHOD_BY_NAME)}"
                )
            existing = st.settings.learning_method
            if existing is not None and existing.kind == v:
                continue  # keep e.g. default_momentum()'s configured instance
            v = _METHOD_BY_NAME[v]()
        if hasattr(st.settings, k):
            setattr(st.settings, k, v)


@dataclasses.dataclass
class DataConfig:
    """Old-face data declaration (reference config_parser.py SimpleData:986,
    ProtoData, PyData): records the provider kind + its knobs; the data
    plane reads these as plain config, the reference's C++ providers are
    replaced by the reader pipeline."""

    kind: str = "simple"
    files: Optional[str] = None
    feat_dim: Optional[int] = None
    context_len: int = 0
    buffer_capacity: int = 0
    type: Optional[str] = None
    load_data_module: Optional[str] = None
    load_data_object: Optional[str] = None
    load_data_args: Optional[str] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def SimpleData(files=None, feat_dim=None, context_len=0, buffer_capacity=0,
               **kw):
    return DataConfig(
        kind="simple", files=files, feat_dim=feat_dim,
        context_len=context_len or 0, buffer_capacity=buffer_capacity,
        extra=kw,
    )


def ProtoData(files=None, type=None, feat_dim=None, buffer_capacity=0, **kw):
    return DataConfig(
        kind="proto", files=files, type=type, feat_dim=feat_dim,
        buffer_capacity=buffer_capacity, extra=kw,
    )


def PyData(files=None, type=None, load_data_module=None,
           load_data_object=None, load_data_args=None, **kw):
    return DataConfig(
        kind="py", files=files, type=type,
        load_data_module=load_data_module, load_data_object=load_data_object,
        load_data_args=load_data_args, extra=kw,
    )


def TrainData(data_config, async_load_data=None):
    """reference config_parser.py:1115 — declare the training data config."""
    _require_state().train_data = data_config


def TestData(data_config, async_load_data=None):
    """reference config_parser.py:1127."""
    _require_state().test_data = data_config


def define_py_data_sources2(train_list, test_list, module, obj, args=None):
    st = _require_state()
    if isinstance(obj, (list, tuple)):
        obj, test_obj = obj
    else:
        test_obj = obj
    if isinstance(module, (list, tuple)):
        # split datasource: [train_module, test_module] (reference
        # data_sources.py define_py_data_sources list form)
        module, test_module = module
    else:
        test_module = module
    st.data_sources = DataSources(
        train_list=train_list, test_list=test_list, module=module,
        obj=obj, test_obj=test_obj, args=args, test_module=test_module,
    )


def Inputs(*names):
    """Capital-I config_parser form: declares input LAYER NAMES (strings)
    and PINS the feeding order — "the data streams from DataProvider must
    have the same order" (reference config_parser.py:205-222).  parse_config
    copies this order onto Topology.input_order; without it feeding order is
    DFS from the outputs.  Inside a SubModelBegin block the names belong to
    that sub-model (multi_nn groups slots per sub-network the way the
    reference splits inArgs by dataId, MultiNetwork.cpp:70)."""
    st = _require_state()
    if st.submodel_stack:
        st.submodel_stack[-1]["inputs"].extend(names)
    else:
        # APPEND, like the reference (config_parser.py:212 appends each name
        # to input_layer_names) — configs may declare Inputs incrementally
        st.input_names.extend(names)


def Outputs(*names):
    """Capital-O form: output layer NAMES (strings) — parse_config resolves
    them against every layer built during the exec (LayerOutput sink).
    Inside a SubModelBegin block the names are that sub-model's outputs."""
    st = _require_state()
    if st.submodel_stack:
        st.submodel_stack[-1]["outputs"].extend(names)
    else:
        st.pending_output_names = list(names)


def SubModelBegin(name):
    """Open a sub-model block (reference config_parser.py:249; consumed by
    MultiNetwork for model_type('multi_nn') ensembles).  Layers share one
    global namespace and parameter table across sub-models, exactly as the
    reference's MultiNetwork keeps all Parameters on the root network."""
    st = _require_state()
    if any(sm["name"] == name for sm in st.submodels):
        raise ValueError(f"Duplicated submodel name: {name}")
    sm = {"name": name, "inputs": [], "outputs": []}
    st.submodels.append(sm)
    st.submodel_stack.append(sm)


def SubModelEnd(name=None):
    """Close the current sub-model block (reference config_parser.py:265)."""
    st = _require_state()
    assert st.submodel_stack, "SubModelEnd without SubModelBegin"
    sm = st.submodel_stack.pop()
    if name is not None and sm["name"] != name:
        raise ValueError(f"SubModelEnd({name!r}) closes submodel {sm['name']!r}")


def inputs(*layers_):
    st = _require_state()
    flat: List[LayerOutput] = []
    for l in layers_:
        flat.extend(l if isinstance(l, (list, tuple)) else [l])
    st.inputs = flat


def outputs(*layers_):
    st = _require_state()
    flat: List[LayerOutput] = []
    for l in layers_:
        flat.extend(l if isinstance(l, (list, tuple)) else [l])
    st.outputs.extend(flat)


def default_device(device_id: int) -> None:
    """v1 global device selector — a no-op here (the device comes from the
    entry points' ``device=``;
    reference config_parser default_device sets per-layer device ids)."""


def default_momentum(momentum: float) -> None:
    """v1 global default — folded into settings().learning_method here;
    recorded so make_optimizer can apply it when settings() didn't name a
    momentum."""
    st = _require_state()
    if st.settings.learning_method is None:
        st.settings.learning_method = MomentumOptimizer(momentum=momentum)


def default_decay_rate(rate: float) -> None:
    """v1 global weight-decay default -> settings().regularization."""
    st = _require_state()
    if st.settings.regularization is None:
        st.settings.regularization = L2Regularization(rate)


def default_initial_std(std: float) -> None:
    """Accepted for config compatibility (per-layer ParamAttr initial_std is
    the supported path)."""


def default_initial_mean(mean: float) -> None:
    """Accepted for config compatibility."""


def _recording_evaluator(fn):
    def wrapper(*args, **kw):
        ev = fn(*args, **kw)
        if _state is not None:
            _state.evaluators.append(ev)
        return ev

    wrapper.__name__ = fn.__name__
    return wrapper


# Evaluator declarations (reference trainer_config_helpers/evaluators.py):
# calling one inside a config registers it with the parse result.
classification_error_evaluator = _recording_evaluator(_ev.classification_error_evaluator)
sum_evaluator = _recording_evaluator(_ev.sum_evaluator)
column_sum_evaluator = _recording_evaluator(_ev.column_sum_evaluator)
auc_evaluator = _recording_evaluator(_ev.auc_evaluator)
precision_recall_evaluator = _recording_evaluator(_ev.precision_recall_evaluator)
pnpair_evaluator = _recording_evaluator(_ev.pnpair_evaluator)
ctc_error_evaluator = _recording_evaluator(_ev.ctc_error_evaluator)
chunk_evaluator = _recording_evaluator(_ev.chunk_evaluator)
detection_map_evaluator = _recording_evaluator(_ev.detection_map_evaluator)
value_printer_evaluator = _recording_evaluator(_ev.value_printer_evaluator)
maxid_printer_evaluator = _recording_evaluator(_ev.maxid_printer_evaluator)
maxframe_printer_evaluator = _recording_evaluator(_ev.maxframe_printer_evaluator)
classification_error_printer_evaluator = _recording_evaluator(
    _ev.classification_error_printer_evaluator
)
gradient_printer_evaluator = _recording_evaluator(_ev.gradient_printer_evaluator)
seqtext_printer_evaluator = _recording_evaluator(_ev.seq_text_printer_evaluator)

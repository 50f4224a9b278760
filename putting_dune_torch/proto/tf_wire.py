"""TensorFlow's SavedModel and checkpoint messages on the port's wire codec.

The messages that `saved_model.pb` and a `variables/` tensor bundle hold,
as `wire.Message` classes, so that `io/tf_export.py` reads and writes
SavedModels without the `protobuf` or `tensorflow` packages. The field
numbers, names and kinds are those of TensorFlow's own `.proto` files
(each class names its message in `TF_NAME`; a test holds every field to
the installed TensorFlow's descriptors). XLA's `xla_data.proto` messages
that the `Xla*` ops of a jax2tf graph carry as serialized string attrs
(`ConvolutionDimensionNumbers`, `DotDimensionNumbers`, ...) are here too.
Fields a SavedModel of the kinds read and written here does not use (debug
info, assets, slot variables' details, full types) are left out: the codec
keeps them as unknown fields and writes them back unchanged.

TensorFlow's files are proto3: a field holding its default is not
written. The builders here set only fields that hold other values.
`map<uint32, X>` fields are declared as their repeated entry messages.
"""

from __future__ import annotations

from putting_dune_torch.proto import wire
from putting_dune_torch.proto.wire import (BOOL, BYTES, DOUBLE, FIXED32,
                                           FLOAT, INT32, INT64, MESSAGE,
                                           SINT64, STRING, UINT32, Message)

_f = wire._f  # pylint: disable=protected-access

# tensorflow.DataType values used here.
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_STRING, DT_INT64, DT_BOOL, DT_RESOURCE = (
    1, 2, 3, 7, 9, 10, 20)


def _fields(cls, *fields):
  """Sets a message's fields after the class exists (messages that refer
  to each other, or to themselves)."""
  cls.FIELDS = tuple(fields)
  cls._by_name = {f.name: f for f in cls.FIELDS}
  cls._by_number = {f.number: f for f in cls.FIELDS}
  cls._ordered = tuple(sorted(cls.FIELDS, key=lambda f: f.number))


def _msg(name: str, tf_name: str):
  return type(name, (Message,), {'__slots__': (), 'TF_NAME': tf_name})


TensorShapeProto = wire.TensorShapeProtoCompat
TensorShapeProto.TF_NAME = 'tensorflow.TensorShapeProto'
TensorShapeProtoDim = wire.TensorShapeProtoCompatDim
TensorShapeProtoDim.TF_NAME = 'tensorflow.TensorShapeProto.Dim'
TensorProto = wire.TensorProtoCompat
TensorProto.TF_NAME = 'tensorflow.TensorProto'

VersionDef = _msg('VersionDef', 'tensorflow.VersionDef')
_fields(VersionDef, _f(1, 'producer', INT32), _f(2, 'min_consumer', INT32),
        _f(3, 'bad_consumers', INT32, repeated=True, packed=True))

NameAttrList = _msg('NameAttrList', 'tensorflow.NameAttrList')
AttrValue = _msg('AttrValue', 'tensorflow.AttrValue')
AttrValueListValue = _msg('AttrValueListValue', 'tensorflow.AttrValue.ListValue')
_fields(AttrValueListValue,
        _f(2, 's', BYTES, repeated=True),
        _f(3, 'i', INT64, repeated=True, packed=True),
        _f(4, 'f', FLOAT, repeated=True, packed=True),
        _f(5, 'b', BOOL, repeated=True, packed=True),
        _f(6, 'type', INT32, repeated=True, packed=True),
        _f(7, 'shape', MESSAGE, repeated=True, message=TensorShapeProto),
        _f(8, 'tensor', MESSAGE, repeated=True, message=TensorProto),
        _f(9, 'func', MESSAGE, repeated=True, message=NameAttrList))
_fields(AttrValue,
        _f(1, 'list', MESSAGE, message=AttrValueListValue),
        _f(2, 's', BYTES), _f(3, 'i', INT64), _f(4, 'f', FLOAT),
        _f(5, 'b', BOOL), _f(6, 'type', INT32),
        _f(7, 'shape', MESSAGE, message=TensorShapeProto),
        _f(8, 'tensor', MESSAGE, message=TensorProto),
        _f(9, 'placeholder', STRING),
        _f(10, 'func', MESSAGE, message=NameAttrList))
_fields(NameAttrList, _f(1, 'name', STRING),
        _f(2, 'attr', MESSAGE, map_value=(MESSAGE, AttrValue)))

NodeDef = _msg('NodeDef', 'tensorflow.NodeDef')
_fields(NodeDef, _f(1, 'name', STRING), _f(2, 'op', STRING),
        _f(3, 'input', STRING, repeated=True), _f(4, 'device', STRING),
        _f(5, 'attr', MESSAGE, map_value=(MESSAGE, AttrValue)))

OpDefArgDef = _msg('OpDefArgDef', 'tensorflow.OpDef.ArgDef')
_fields(OpDefArgDef, _f(1, 'name', STRING), _f(2, 'description', STRING),
        _f(3, 'type', INT32), _f(4, 'type_attr', STRING),
        _f(5, 'number_attr', STRING), _f(6, 'type_list_attr', STRING),
        _f(16, 'is_ref', BOOL))
OpDefAttrDef = _msg('OpDefAttrDef', 'tensorflow.OpDef.AttrDef')
_fields(OpDefAttrDef, _f(1, 'name', STRING), _f(2, 'type', STRING),
        _f(3, 'default_value', MESSAGE, message=AttrValue),
        _f(4, 'description', STRING), _f(5, 'has_minimum', BOOL),
        _f(6, 'minimum', INT64),
        _f(7, 'allowed_values', MESSAGE, message=AttrValue))
OpDef = _msg('OpDef', 'tensorflow.OpDef')
_fields(OpDef, _f(1, 'name', STRING),
        _f(2, 'input_arg', MESSAGE, repeated=True, message=OpDefArgDef),
        _f(3, 'output_arg', MESSAGE, repeated=True, message=OpDefArgDef),
        _f(20, 'control_output', STRING, repeated=True),
        _f(4, 'attr', MESSAGE, repeated=True, message=OpDefAttrDef),
        _f(5, 'summary', STRING), _f(6, 'description', STRING),
        _f(18, 'is_commutative', BOOL), _f(16, 'is_aggregate', BOOL),
        _f(17, 'is_stateful', BOOL),
        _f(19, 'allows_uninitialized_input', BOOL),
        _f(21, 'is_distributed_communication', BOOL))
OpList = _msg('OpList', 'tensorflow.OpList')
_fields(OpList, _f(1, 'op', MESSAGE, repeated=True, message=OpDef))

FunctionDefArgAttrs = _msg('FunctionDefArgAttrs',
                           'tensorflow.FunctionDef.ArgAttrs')
_fields(FunctionDefArgAttrs,
        _f(1, 'attr', MESSAGE, map_value=(MESSAGE, AttrValue)))
FunctionDefArgAttrEntry = _msg('FunctionDefArgAttrEntry',
                               'tensorflow.FunctionDef.ArgAttrEntry')
_fields(FunctionDefArgAttrEntry, _f(1, 'key', UINT32),
        _f(2, 'value', MESSAGE, message=FunctionDefArgAttrs))
FunctionDef = _msg('FunctionDef', 'tensorflow.FunctionDef')
_fields(FunctionDef,
        _f(1, 'signature', MESSAGE, message=OpDef),
        _f(5, 'attr', MESSAGE, map_value=(MESSAGE, AttrValue)),
        _f(7, 'arg_attr', MESSAGE, repeated=True,
           message=FunctionDefArgAttrEntry),
        _f(3, 'node_def', MESSAGE, repeated=True, message=NodeDef),
        _f(4, 'ret', MESSAGE, map_value=(STRING, None)),
        _f(6, 'control_ret', MESSAGE, map_value=(STRING, None)))
FunctionDefLibrary = _msg('FunctionDefLibrary',
                          'tensorflow.FunctionDefLibrary')
RegisteredGradient = _msg('RegisteredGradient', 'tensorflow.RegisteredGradient')
_fields(RegisteredGradient, _f(1, 'gradient_func', STRING),
        _f(2, 'registered_op_type', STRING))
_fields(FunctionDefLibrary,
        _f(1, 'function', MESSAGE, repeated=True, message=FunctionDef),
        _f(3, 'registered_gradients', MESSAGE, repeated=True,
           message=RegisteredGradient))

GraphDef = _msg('GraphDef', 'tensorflow.GraphDef')
_fields(GraphDef, _f(1, 'node', MESSAGE, repeated=True, message=NodeDef),
        _f(4, 'versions', MESSAGE, message=VersionDef),
        _f(3, 'version', INT32),
        _f(2, 'library', MESSAGE, message=FunctionDefLibrary))

MetaInfoDef = _msg('MetaInfoDef', 'tensorflow.MetaGraphDef.MetaInfoDef')
_fields(MetaInfoDef, _f(1, 'meta_graph_version', STRING),
        _f(2, 'stripped_op_list', MESSAGE, message=OpList),
        _f(4, 'tags', STRING, repeated=True),
        _f(5, 'tensorflow_version', STRING),
        _f(6, 'tensorflow_git_version', STRING),
        _f(7, 'stripped_default_attrs', BOOL),
        _f(8, 'function_aliases', MESSAGE, map_value=(STRING, None)))

SaverDef = _msg('SaverDef', 'tensorflow.SaverDef')
_fields(SaverDef, _f(1, 'filename_tensor_name', STRING),
        _f(2, 'save_tensor_name', STRING), _f(3, 'restore_op_name', STRING),
        _f(4, 'max_to_keep', INT32), _f(5, 'sharded', BOOL),
        _f(6, 'keep_checkpoint_every_n_hours', FLOAT),
        _f(7, 'version', INT32))

CollectionDefNodeList = _msg('CollectionDefNodeList',
                             'tensorflow.CollectionDef.NodeList')
_fields(CollectionDefNodeList, _f(1, 'value', STRING, repeated=True))
CollectionDef = _msg('CollectionDef', 'tensorflow.CollectionDef')
_fields(CollectionDef,
        _f(1, 'node_list', MESSAGE, message=CollectionDefNodeList))

TensorInfo = _msg('TensorInfo', 'tensorflow.TensorInfo')
_fields(TensorInfo, _f(1, 'name', STRING), _f(2, 'dtype', INT32),
        _f(3, 'tensor_shape', MESSAGE, message=TensorShapeProto))
SignatureDef = _msg('SignatureDef', 'tensorflow.SignatureDef')
_fields(SignatureDef,
        _f(1, 'inputs', MESSAGE, map_value=(MESSAGE, TensorInfo)),
        _f(2, 'outputs', MESSAGE, map_value=(MESSAGE, TensorInfo)),
        _f(3, 'method_name', STRING))

# --- the object graph --------------------------------------------------------

NoneValue = _msg('NoneValue', 'tensorflow.NoneValue')
_fields(NoneValue)
StructuredValue = _msg('StructuredValue', 'tensorflow.StructuredValue')
ListValue = _msg('ListValue', 'tensorflow.ListValue')
TupleValue = _msg('TupleValue', 'tensorflow.TupleValue')
DictValue = _msg('DictValue', 'tensorflow.DictValue')
PairValue = _msg('PairValue', 'tensorflow.PairValue')
NamedTupleValue = _msg('NamedTupleValue', 'tensorflow.NamedTupleValue')
TensorSpecProto = _msg('TensorSpecProto', 'tensorflow.TensorSpecProto')
_fields(TensorSpecProto, _f(1, 'name', STRING),
        _f(2, 'shape', MESSAGE, message=TensorShapeProto),
        _f(3, 'dtype', INT32))
_fields(StructuredValue,
        _f(1, 'none_value', MESSAGE, message=NoneValue),
        _f(11, 'float64_value', DOUBLE), _f(12, 'int64_value', SINT64),
        _f(13, 'string_value', STRING), _f(14, 'bool_value', BOOL),
        _f(31, 'tensor_shape_value', MESSAGE, message=TensorShapeProto),
        _f(32, 'tensor_dtype_value', INT32),
        _f(33, 'tensor_spec_value', MESSAGE, message=TensorSpecProto),
        _f(51, 'list_value', MESSAGE, message=ListValue),
        _f(52, 'tuple_value', MESSAGE, message=TupleValue),
        _f(53, 'dict_value', MESSAGE, message=DictValue),
        _f(54, 'named_tuple_value', MESSAGE, message=NamedTupleValue))
_fields(ListValue,
        _f(1, 'values', MESSAGE, repeated=True, message=StructuredValue))
_fields(TupleValue,
        _f(1, 'values', MESSAGE, repeated=True, message=StructuredValue))
_fields(DictValue,
        _f(1, 'fields', MESSAGE, map_value=(MESSAGE, StructuredValue)))
_fields(PairValue, _f(1, 'key', STRING),
        _f(2, 'value', MESSAGE, message=StructuredValue))
_fields(NamedTupleValue, _f(1, 'name', STRING),
        _f(2, 'values', MESSAGE, repeated=True, message=PairValue))

ObjectReference = _msg(
    'ObjectReference',
    'tensorflow.TrackableObjectGraph.TrackableObject.ObjectReference')
_fields(ObjectReference, _f(1, 'node_id', INT32), _f(2, 'local_name', STRING))

SavedUserObject = _msg('SavedUserObject', 'tensorflow.SavedUserObject')
_fields(SavedUserObject, _f(1, 'identifier', STRING),
        _f(2, 'version', MESSAGE, message=VersionDef),
        _f(3, 'metadata', STRING))
FunctionSpec = _msg('FunctionSpec', 'tensorflow.FunctionSpec')
_fields(FunctionSpec,
        _f(1, 'fullargspec', MESSAGE, message=StructuredValue),
        _f(2, 'is_method', BOOL),
        _f(5, 'input_signature', MESSAGE, message=StructuredValue),
        _f(6, 'jit_compile', INT32))
SavedFunction = _msg('SavedFunction', 'tensorflow.SavedFunction')
_fields(SavedFunction, _f(1, 'concrete_functions', STRING, repeated=True),
        _f(2, 'function_spec', MESSAGE, message=FunctionSpec))
SavedBareConcreteFunction = _msg('SavedBareConcreteFunction',
                                 'tensorflow.SavedBareConcreteFunction')
_fields(SavedBareConcreteFunction, _f(1, 'concrete_function_name', STRING),
        _f(2, 'argument_keywords', STRING, repeated=True),
        _f(3, 'allowed_positional_arguments', INT64),
        _f(4, 'function_spec', MESSAGE, message=FunctionSpec))
SavedVariable = _msg('SavedVariable', 'tensorflow.SavedVariable')
_fields(SavedVariable, _f(1, 'dtype', INT32),
        _f(2, 'shape', MESSAGE, message=TensorShapeProto),
        _f(3, 'trainable', BOOL), _f(4, 'synchronization', INT32),
        _f(5, 'aggregation', INT32), _f(6, 'name', STRING),
        _f(7, 'device', STRING))
SavedConstant = _msg('SavedConstant', 'tensorflow.SavedConstant')
_fields(SavedConstant, _f(1, 'operation', STRING))
SavedResource = _msg('SavedResource', 'tensorflow.SavedResource')
_fields(SavedResource, _f(1, 'device', STRING))
CapturedTensor = _msg('CapturedTensor', 'tensorflow.CapturedTensor')
_fields(CapturedTensor, _f(1, 'name', STRING),
        _f(2, 'concrete_function', STRING))
SavedObject = _msg('SavedObject', 'tensorflow.SavedObject')
_fields(SavedObject,
        _f(1, 'children', MESSAGE, repeated=True, message=ObjectReference),
        _f(15, 'dependencies', MESSAGE, repeated=True,
           message=ObjectReference),
        _f(4, 'user_object', MESSAGE, message=SavedUserObject),
        _f(6, 'function', MESSAGE, message=SavedFunction),
        _f(7, 'variable', MESSAGE, message=SavedVariable),
        _f(8, 'bare_concrete_function', MESSAGE,
           message=SavedBareConcreteFunction),
        _f(9, 'constant', MESSAGE, message=SavedConstant),
        _f(10, 'resource', MESSAGE, message=SavedResource),
        _f(12, 'captured_tensor', MESSAGE, message=CapturedTensor),
        _f(13, 'registered_name', STRING),
        _f(16, 'registered_saver', STRING))
SavedConcreteFunction = _msg('SavedConcreteFunction',
                             'tensorflow.SavedConcreteFunction')
_fields(SavedConcreteFunction,
        _f(2, 'bound_inputs', INT32, repeated=True, packed=True),
        _f(3, 'canonicalized_input_signature', MESSAGE,
           message=StructuredValue),
        _f(4, 'output_signature', MESSAGE, message=StructuredValue))
SavedObjectGraph = _msg('SavedObjectGraph', 'tensorflow.SavedObjectGraph')
_fields(SavedObjectGraph,
        _f(1, 'nodes', MESSAGE, repeated=True, message=SavedObject),
        _f(2, 'concrete_functions', MESSAGE,
           map_value=(MESSAGE, SavedConcreteFunction)))

MetaGraphDef = _msg('MetaGraphDef', 'tensorflow.MetaGraphDef')
_fields(MetaGraphDef,
        _f(1, 'meta_info_def', MESSAGE, message=MetaInfoDef),
        _f(2, 'graph_def', MESSAGE, message=GraphDef),
        _f(3, 'saver_def', MESSAGE, message=SaverDef),
        _f(4, 'collection_def', MESSAGE, map_value=(MESSAGE, CollectionDef)),
        _f(5, 'signature_def', MESSAGE, map_value=(MESSAGE, SignatureDef)),
        _f(7, 'object_graph_def', MESSAGE, message=SavedObjectGraph))
SavedModel = _msg('SavedModel', 'tensorflow.SavedModel')
_fields(SavedModel, _f(1, 'saved_model_schema_version', INT64),
        _f(2, 'meta_graphs', MESSAGE, repeated=True, message=MetaGraphDef))

# --- XLA's attrs (xla_data.proto) --------------------------------------------

ConvolutionDimensionNumbers = _msg('ConvolutionDimensionNumbers',
                                   'xla.ConvolutionDimensionNumbers')
_fields(ConvolutionDimensionNumbers,
        _f(7, 'input_batch_dimension', INT64),
        _f(8, 'input_feature_dimension', INT64),
        _f(11, 'input_spatial_dimensions', INT64, repeated=True, packed=True),
        _f(3, 'kernel_input_feature_dimension', INT64),
        _f(4, 'kernel_output_feature_dimension', INT64),
        _f(6, 'kernel_spatial_dimensions', INT64, repeated=True, packed=True),
        _f(9, 'output_batch_dimension', INT64),
        _f(10, 'output_feature_dimension', INT64),
        _f(12, 'output_spatial_dimensions', INT64, repeated=True,
           packed=True))
DotDimensionNumbers = _msg('DotDimensionNumbers', 'xla.DotDimensionNumbers')
_fields(DotDimensionNumbers,
        _f(1, 'lhs_contracting_dimensions', INT64, repeated=True, packed=True),
        _f(2, 'rhs_contracting_dimensions', INT64, repeated=True, packed=True),
        _f(3, 'lhs_batch_dimensions', INT64, repeated=True, packed=True),
        _f(4, 'rhs_batch_dimensions', INT64, repeated=True, packed=True))
GatherDimensionNumbers = _msg('GatherDimensionNumbers',
                              'xla.GatherDimensionNumbers')
_fields(GatherDimensionNumbers,
        _f(1, 'offset_dims', INT64, repeated=True, packed=True),
        _f(2, 'collapsed_slice_dims', INT64, repeated=True, packed=True),
        _f(3, 'start_index_map', INT64, repeated=True, packed=True),
        _f(4, 'index_vector_dim', INT64),
        _f(5, 'operand_batching_dims', INT64, repeated=True, packed=True),
        _f(6, 'start_indices_batching_dims', INT64, repeated=True,
           packed=True))
ScatterDimensionNumbers = _msg('ScatterDimensionNumbers',
                               'xla.ScatterDimensionNumbers')
_fields(ScatterDimensionNumbers,
        _f(1, 'update_window_dims', INT64, repeated=True, packed=True),
        _f(2, 'inserted_window_dims', INT64, repeated=True, packed=True),
        _f(3, 'scatter_dims_to_operand_dims', INT64, repeated=True,
           packed=True),
        _f(4, 'index_vector_dim', INT64),
        _f(5, 'input_batching_dims', INT64, repeated=True, packed=True),
        _f(6, 'scatter_indices_batching_dims', INT64, repeated=True,
           packed=True))
# Enums (xla.PrecisionConfig.Precision, .Algorithm) are int32 on the wire.
PrecisionConfig = _msg('PrecisionConfig', 'xla.PrecisionConfig')
_fields(PrecisionConfig,
        _f(1, 'operand_precision', INT32, repeated=True, packed=True),
        _f(2, 'algorithm', INT32))

# --- checkpoints -------------------------------------------------------------

SerializedTensor = _msg(
    'SerializedTensor',
    'tensorflow.TrackableObjectGraph.TrackableObject.SerializedTensor')
_fields(SerializedTensor, _f(1, 'name', STRING), _f(2, 'full_name', STRING),
        _f(3, 'checkpoint_key', STRING))
TrackableObject = _msg('TrackableObject',
                       'tensorflow.TrackableObjectGraph.TrackableObject')
_fields(TrackableObject,
        _f(1, 'children', MESSAGE, repeated=True, message=ObjectReference),
        _f(2, 'attributes', MESSAGE, repeated=True, message=SerializedTensor))
TrackableObjectGraph = _msg('TrackableObjectGraph',
                            'tensorflow.TrackableObjectGraph')
_fields(TrackableObjectGraph,
        _f(1, 'nodes', MESSAGE, repeated=True, message=TrackableObject))

BundleHeaderProto = _msg('BundleHeaderProto', 'tensorflow.BundleHeaderProto')
_fields(BundleHeaderProto, _f(1, 'num_shards', INT32),
        _f(2, 'endianness', INT32),
        _f(3, 'version', MESSAGE, message=VersionDef))
TensorSliceProto = _msg('TensorSliceProto', 'tensorflow.TensorSliceProto')
_fields(TensorSliceProto)
BundleEntryProto = _msg('BundleEntryProto', 'tensorflow.BundleEntryProto')
_fields(BundleEntryProto, _f(1, 'dtype', INT32),
        _f(2, 'shape', MESSAGE, message=TensorShapeProto),
        _f(3, 'shard_id', INT32), _f(4, 'offset', INT64),
        _f(5, 'size', INT64), _f(6, 'crc32c', FIXED32),
        _f(7, 'slices', MESSAGE, repeated=True, message=TensorSliceProto))

MESSAGES = (
    VersionDef, NameAttrList, AttrValue, AttrValueListValue, NodeDef,
    OpDefArgDef, OpDefAttrDef, OpDef, OpList, FunctionDefArgAttrs,
    FunctionDefArgAttrEntry, FunctionDef, RegisteredGradient,
    FunctionDefLibrary, GraphDef,
    MetaInfoDef, SaverDef, CollectionDefNodeList, CollectionDef, TensorInfo,
    SignatureDef, NoneValue, StructuredValue, ListValue, TupleValue,
    DictValue, PairValue, NamedTupleValue, TensorSpecProto, ObjectReference,
    SavedUserObject, FunctionSpec, SavedFunction, SavedBareConcreteFunction,
    SavedVariable, SavedConstant, SavedResource, CapturedTensor, SavedObject,
    SavedConcreteFunction, SavedObjectGraph, MetaGraphDef, SavedModel,
    SerializedTensor, TrackableObject, TrackableObjectGraph,
    BundleHeaderProto, TensorSliceProto, BundleEntryProto, TensorShapeProto,
    TensorShapeProtoDim, TensorProto, ConvolutionDimensionNumbers,
    DotDimensionNumbers, GatherDimensionNumbers, ScatterDimensionNumbers,
    PrecisionConfig)

from deeplearning4j_tpu_torch.streaming.serde import (
    BadRecordError, array_to_base64, base64_to_array, consume_dataset_json,
    dataset_to_json, dataset_from_json, record_to_dataset,
)
from deeplearning4j_tpu_torch.streaming.pubsub import (
    MessageBroker, NDArrayPublisher, NDArrayConsumer,
)
from deeplearning4j_tpu_torch.streaming.serving import (
    InferenceServer, StreamingPipeline, ServingPipeline,
)

from tmv_tpu_torch.models.facenet.model import (  # noqa: F401
    FaceNetModel,
    get_embeddings,
    make_triplet_train_step,
    select_triplets,
)

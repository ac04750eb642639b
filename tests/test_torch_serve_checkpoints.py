"""The port's server loads what the port's trainers and converter write.

``cli/train_yolo.py`` (v4 and v3) and ``cli/train_efficientdet.py`` take 2 steps
(one epoch, one checkpoint) on the CPU at 64 px; ``cli/serve.py --modelPath <their directory>`` then serves
the latest step's weights (equal to the checkpoint's ``model`` tensor for
tensor) and answers one request with the reference's keys. ``core.checkpoint.
load_weights`` takes a bare ``state_dict`` ``.pt`` too, and raises for a
directory without a checkpoint.
"""

import pytest
import torch

from tmv_tpu_torch.cli import serve, train_efficientdet, train_yolo
from tmv_tpu_torch.core.checkpoint import load_weights
from tmv_tpu_torch.models.detector_harness import build_yolo_model
from torch_port_cases import (  # noqa: F401
    answer_one_request, disposable_tmp, one_torch_thread, write_tiny_set,
)


def train(files, family, version, ckpt):
    common = ["--trainData", files["labels"], "--trainImagePath", files["images"],
              "--classesFile", files["classes"], "--imageSize", "64", "--batchSize", "2",
              "--stepsPerEpoch", "2", "--epochs", "1", "--modelPath", str(ckpt),
              "--device", "cpu"]
    if family == "efficientdet":
        return train_efficientdet.main(common + ["--modelName", "efficientdet-d0"])
    return train_yolo.main(common + ["--version", version, "--anchorsFile", files["anchors"]])


@pytest.mark.parametrize("family, version", [("yolo", "v4"), ("yolo", "v3"),
                                             ("efficientdet", "d0")])
def test_serve_answers_from_a_trainer_checkpoint_directory(disposable_tmp, capsys,
                                                           one_torch_thread, family, version):
    files = write_tiny_set(disposable_tmp)
    ckpt = disposable_tmp / "ckpt"
    assert train(files, family, version, ckpt)["step"] == 2
    args = ["--modelPath", str(ckpt), "--classesFile", files["classes"], "--imageSize", "64",
            "--device", "cpu"]
    if family == "efficientdet":
        args += ["--family", "efficientdet", "--modelName", "efficientdet-d0"]
    else:
        args += ["--version", version, "--anchorsFile", files["anchors"]]
    app, service, model = serve.build_app(serve.parse_args(args))
    assert "checkpoint at step 2" in capsys.readouterr().out
    saved = torch.load(ckpt / "2.pt", weights_only=True)["model"]
    served = model.state_dict()
    assert set(served) == set(saved)
    assert all(torch.equal(served[k], v.to(served[k].dtype)) for k, v in saved.items())
    status, answer = answer_one_request(app)
    assert status.startswith("200"), answer
    assert set(answer) == {"boxes", "classes", "random_img", "result_img"}
    assert service.request_count == 1


def test_load_weights_takes_a_state_dict_and_refuses_an_empty_directory(disposable_tmp):
    tmp_path = disposable_tmp
    source, _ = build_yolo_model("v3", 2, device="cpu")
    torch.save(source.state_dict(), tmp_path / "bare.pt")
    model, _ = build_yolo_model("v3", 2, device="cpu")
    assert load_weights(model, str(tmp_path / "bare.pt")) is None
    assert all(torch.equal(v, source.state_dict()[k]) for k, v in model.state_dict().items())
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="holds no checkpoint"):
        load_weights(model, str(tmp_path / "empty"))

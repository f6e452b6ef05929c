// hostcomm — native TCP object-plane transport between processes.
//
// The port's copy of the JAX package's `_native/hostcomm.cpp`: the host
// object plane that the reference ran over mpi4py (bcast_obj/gather_obj/
// send_obj/recv_obj — SURVEY.md §2.1 "MPI binding").  Tensors travel over
// the process group's collectives; this carries pickled bytes point to
// point between processes, from which Python composes barrier, bcast,
// gather and allgather.
//
// Design: full peer mesh over TCP.  Rank r listens on ports[r]; on init
// every pair (i < j) is connected once (j dials i, sends its rank as a
// 4-byte hello).  Frames are [u64 length][payload].  A background reader
// thread per peer demultiplexes frames into per-source queues so sends
// never deadlock against out-of-order receives (FIFO per source).
//
// Exposed as a C ABI for ctypes.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<uint8_t> data;
};

struct PeerQueue {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Frame> frames;
};

struct Comm {
  int rank = -1;
  int size = 0;
  std::vector<int> fds;                 // fds[peer] (-1 for self)
  std::vector<std::unique_ptr<PeerQueue>> queues;
  std::vector<std::thread> readers;
  std::vector<std::mutex> send_mu;      // one writer lock per peer fd
  bool failed = false;
  std::string error;
};

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

// Deadline-bounded send: poll for writability, then non-blocking send, so a
// dead peer whose socket buffer is full fails the op after deadline_ms
// instead of wedging the sender forever (the reference's MPI_Send had the
// same silent-blocking failure mode).  deadline_ms < 0 → wait forever.
// Returns 0 ok, -2 connection failure, -3 timeout.
int send_all_deadline(int fd, const void* buf, size_t n, int deadline_ms) {
  if (deadline_ms < 0) return send_all(fd, buf, n) ? 0 : -2;
  const char* p = static_cast<const char*>(buf);
  auto t0 = std::chrono::steady_clock::now();
  while (n > 0) {
    auto elapsed = std::chrono::duration_cast<std::chrono::milliseconds>(
                       std::chrono::steady_clock::now() - t0)
                       .count();
    int remain = deadline_ms - static_cast<int>(elapsed);
    if (remain <= 0) return -3;
    pollfd pfd{fd, POLLOUT, 0};
    int pr = ::poll(&pfd, 1, remain);
    if (pr == 0) return -3;
    if (pr < 0 || (pfd.revents & (POLLERR | POLLHUP | POLLNVAL))) return -2;
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL | MSG_DONTWAIT);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) continue;
      return -2;
    }
    if (w == 0) return -2;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return 0;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void reader_loop(Comm* c, int peer) {
  int fd = c->fds[peer];
  for (;;) {
    uint64_t len = 0;
    if (!recv_all(fd, &len, sizeof(len))) return;  // peer closed
    Frame f;
    f.data.resize(len);
    if (len > 0 && !recv_all(fd, f.data.data(), len)) return;
    PeerQueue* q = c->queues[peer].get();
    {
      std::lock_guard<std::mutex> lk(q->mu);
      q->frames.push_back(std::move(f));
    }
    q->cv.notify_all();
  }
}

int listen_on(int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 128) < 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

int dial(const char* host, int port, int retries_ms) {
  for (int waited = 0;; waited += 50) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      ::close(fd);
      return -1;
    }
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      return fd;
    }
    ::close(fd);
    if (waited >= retries_ms) return -1;
    ::usleep(50 * 1000);
  }
}

}  // namespace

extern "C" {

// hosts: size C strings (IPv4 dotted quads); rank r listens on ports[r].
// Returns an opaque handle, or nullptr on failure.
void* hostcomm_init(int rank, int size, const char** hosts, const int* ports,
                    int timeout_ms) {
  auto c = std::make_unique<Comm>();
  c->rank = rank;
  c->size = size;
  c->fds.assign(size, -1);
  c->queues.resize(size);
  for (int i = 0; i < size; ++i) c->queues[i] = std::make_unique<PeerQueue>();
  c->send_mu = std::vector<std::mutex>(size);

  int lfd = listen_on(ports[rank]);
  if (lfd < 0) return nullptr;

  // Accept connections from higher ranks in a helper thread while we dial
  // lower ranks — avoids ordering deadlock.  Accepts are poll()-bounded so a
  // dead peer fails init after timeout_ms instead of wedging every rank.
  int expect = size - rank - 1;
  std::thread acceptor([&c, lfd, expect, timeout_ms]() {
    for (int got = 0; got < expect; ++got) {
      pollfd pfd{lfd, POLLIN, 0};
      int pr = ::poll(&pfd, 1, timeout_ms > 0 ? timeout_ms : -1);
      if (pr <= 0) {
        c->failed = true;
        return;
      }
      int fd = ::accept(lfd, nullptr, nullptr);
      if (fd < 0) {
        c->failed = true;
        return;
      }
      // Only HIGHER ranks dial us, each exactly once: a hello from a rank
      // ≤ ours, out of range, or already connected would overwrite (and
      // leak) an established fd — reject it and fail init.
      int32_t peer = -1;
      if (!recv_all(fd, &peer, sizeof(peer)) || peer <= c->rank ||
          peer >= c->size || c->fds[peer] != -1) {
        c->failed = true;
        ::close(fd);
        return;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      c->fds[peer] = fd;
    }
  });

  bool ok = true;
  for (int peer = 0; peer < rank; ++peer) {
    int fd = dial(hosts[peer], ports[peer], timeout_ms);
    if (fd < 0) {
      ok = false;
      break;
    }
    int32_t me = rank;
    if (!send_all(fd, &me, sizeof(me))) {
      ok = false;
      ::close(fd);
      break;
    }
    c->fds[peer] = fd;
  }
  acceptor.join();
  ::close(lfd);
  if (!ok || c->failed) {
    for (int fd : c->fds)
      if (fd >= 0) ::close(fd);
    return nullptr;
  }

  for (int peer = 0; peer < size; ++peer) {
    if (peer == rank) continue;
    c->readers.emplace_back(reader_loop, c.get(), peer);
  }
  return c.release();
}

// Framed send to `dest`, bounded by timeout_ms (< 0 → wait forever).
// Returns 0 ok, -1 bad args, -2 connection failure, -3 timeout.
int hostcomm_send(void* handle, int dest, const uint8_t* data, uint64_t len,
                  int timeout_ms) {
  auto* c = static_cast<Comm*>(handle);
  if (dest < 0 || dest >= c->size || dest == c->rank) return -1;
  std::lock_guard<std::mutex> lk(c->send_mu[dest]);
  auto t0 = std::chrono::steady_clock::now();
  uint64_t n = len;
  int rc = send_all_deadline(c->fds[dest], &n, sizeof(n), timeout_ms);
  if (len > 0 && rc == 0) {
    // The header is committed: spend only whatever deadline REMAINS on
    // the payload, so the whole frame honors one timeout_ms budget.
    int remain = timeout_ms;
    if (timeout_ms >= 0) {
      auto spent = std::chrono::duration_cast<std::chrono::milliseconds>(
                       std::chrono::steady_clock::now() - t0)
                       .count();
      remain = timeout_ms - static_cast<int>(spent);
      if (remain < 0) remain = 0;
    }
    rc = send_all_deadline(c->fds[dest], data, len, remain);
  }
  if (rc != 0) {
    // A failed send may have written part of a frame; the byte stream to
    // this peer is unrecoverable (the reader has no resync point), so
    // poison the channel: shutdown makes the peer's reader see EOF and
    // every later op on this fd fail fast, instead of a silently
    // desynced stream delivering garbage to a retried send.
    ::shutdown(c->fds[dest], SHUT_RDWR);
  }
  return rc;
}

// Blocking receive of the next frame from `source`.  Two-phase: first call
// with buf=nullptr returns the pending frame's length (waiting for arrival);
// then call with a buffer of that size to pop it.  timeout_ms < 0 → wait
// forever.  Returns length, or -1 timeout, -2 bad args.
int64_t hostcomm_recv(void* handle, int source, uint8_t* buf, uint64_t buflen,
                      int timeout_ms) {
  auto* c = static_cast<Comm*>(handle);
  if (source < 0 || source >= c->size || source == c->rank) return -2;
  PeerQueue* q = c->queues[source].get();
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [&] { return !q->frames.empty(); };
  if (timeout_ms < 0) {
    q->cv.wait(lk, ready);
  } else if (!q->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                             ready)) {
    return -1;
  }
  Frame& f = q->frames.front();
  int64_t len = static_cast<int64_t>(f.data.size());
  if (buf == nullptr) return len;  // peek length, leave queued
  if (buflen < f.data.size()) return -2;
  if (len > 0) std::memcpy(buf, f.data.data(), f.data.size());
  q->frames.pop_front();
  return len;
}

void hostcomm_destroy(void* handle) {
  auto* c = static_cast<Comm*>(handle);
  for (int fd : c->fds)
    if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
  for (auto& t : c->readers) t.join();
  for (int fd : c->fds)
    if (fd >= 0) ::close(fd);
  delete c;
}

}  // extern "C"
